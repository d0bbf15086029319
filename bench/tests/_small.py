"""Reduced sizes of the benchmark's configurations for the CPU tests: every
width cut, the structure kept (GQA, top-k over several experts)."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CONFIGS = ("qwen3-moe-30b-a3b", "mixtral-8x22b-pp4")


def small_config(name: str, dtype: str = "bfloat16") -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=256,
               torch_dtype=dtype)
    if "num_experts" in cfg:
        cfg.update(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
    else:
        cfg.update(num_local_experts=4, num_experts_per_tok=2,
                   intermediate_size=32)
    return cfg
