"""Roofline analysis over dry-run records.

Counterpart of ``repro.analysis.roofline``. Per (arch x shape) on the
single-pod mesh:
  compute term    = dot_FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = link_bytes_per_device / link_bw

The dry-run counts rank 0's local work (``analysis.program``), so
per-device quantities over per-device rates equal the global-quantity /
(devices x rate) form. Rates are a ``DeviceProfile``'s, by default
``core.power.H100_SXM`` (989e12 FLOP/s, 3.35e12 B/s HBM, 450e9 B/s link,
80e9 B).

MODEL_FLOPS uses 6*N*D (train) / 2*N*D (inference) with N_active for MoE
plus context-dependent attention-score FLOPs; the MODEL/program ratio flags
remat and dispatch overheads. Records and the table keep the reference's
keys and headings (``hlo_flops_per_dev``, "MODEL/HLO"): here they hold the
traced program's counts. The reference's ``cpu_fp32_artifact_bytes``
(XLA CPU's bf16 upcasts found in HLO text) has no counterpart: a fake run
has no such upcasts, so ``temp_bytes_est`` is the traced peak itself.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.power import H100_SXM, DeviceProfile

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun"


def model_flops_per_device(arch: str, shape_name: str, n_devices: int) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        per_tok = 3.0 * cfg.flops_per_token_total(shape.seq_len // 2)
        return per_tok * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return cfg.flops_per_token_total(shape.seq_len // 2) * tokens / n_devices
    # decode: one token per sequence against a seq_len cache
    tokens = shape.global_batch
    return cfg.flops_per_token_total(shape.seq_len) * tokens / n_devices


def ideal_bytes_per_device(arch: str, shape_name: str, chips: int) -> float:
    """Algorithmic HBM-traffic floor per device: weight shard read once
    per pass, KV cache read/written once, one residual-stream activation
    round-trip per layer."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_act = cfg.active_param_count() * 2
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / max(chips / 16, 1)
        # fwd + bwd weight reads (fp32 master + moments) + grad write
        w = (cfg.param_count() * (4 * 3 + 8 * 2)) / chips
        acts = tokens_dev * cfg.d_model * 2 * cfg.n_layers * 2
        return w + acts
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / max(chips / 16, 1)
        w = n_act / 16                          # TP shard read once
        kv = tokens_dev * cfg.kv_bytes_per_token()
        acts = tokens_dev * cfg.d_model * 2 * cfg.n_layers * 2
        return w + kv + acts
    # decode
    w = n_act / 16
    a = cfg.attention
    ctx = shape.seq_len
    if a is not None and a.sliding_window:
        ctx = min(ctx, a.sliding_window)
    kv_dev = (shape.global_batch * ctx * cfg.kv_bytes_per_token()
              / max(chips / 16, 1))
    return w + kv_dev


def analyze_cell(rec: Dict, device: DeviceProfile = H100_SXM) -> Dict:
    la = rec["loop_aware"]
    coll = rec["collectives"]
    mem = rec["memory"]
    chips = 512 if rec["mesh"] == "2x16x16" else 256

    t_comp = la["dot_flops"] / device.peak_flops
    t_mem = la["hbm_bytes"] / device.hbm_bw
    t_coll = coll["link_bytes"] / device.link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], chips)
    ib = ideal_bytes_per_device(rec["arch"], rec["shape"], chips)
    # the achievable floor is itself a roofline: max(compute, memory) ideal
    t_ideal = max(mf / device.peak_flops, ib / device.hbm_bw, 1e-12)
    t_bound = max(t_comp, t_mem, t_coll)
    temp = mem.get("temp_bytes") or 0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": la["dot_flops"],
        "ideal_bytes_per_dev": ib,
        "hlo_bytes_per_dev": la["hbm_bytes"],
        "useful_ratio": mf / max(la["dot_flops"], 1e-9),
        "t_ideal_s": t_ideal,
        "roofline_fraction": t_ideal / max(t_bound, 1e-12),
        "temp_bytes": temp,
        "temp_bytes_est": temp,
        "argument_bytes": mem.get("argument_bytes") or 0,
        "fits_hbm": (temp + (mem.get("argument_bytes") or 0))
                    < device.hbm_bytes * 1.05,
    }


def load_all(mesh: str = "16x16", device: DeviceProfile = H100_SXM
             ) -> List[Dict]:
    out = []
    for p in sorted((RESULTS / mesh).glob("*.json")):
        rec = json.loads(p.read_text())
        if not rec.get("runnable", False) or "loop_aware" not in rec:
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec.get("mesh", mesh), "skipped": True,
                        "reason": rec.get("reason", rec.get("error", ""))[:90]})
            continue
        out.append(analyze_cell(rec, device))
    return out


def markdown_table(cells: List[Dict], device: DeviceProfile = H100_SXM) -> str:
    cap = f"fits {device.hbm_bytes / 1e9:.0f}G"
    hdr = ("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           f"dominant | MODEL/HLO | roofline frac | {cap} |")
    sep = "|" + "---|" * 9
    rows = [hdr, sep]
    for c in cells:
        if c.get("skipped"):
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skipped: {c['reason'][:40]} | — | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['t_compute_s']*1e3:.2f} | "
            f"{c['t_memory_s']*1e3:.2f} | {c['t_collective_s']*1e3:.2f} | "
            f"{c['dominant']} | {c['useful_ratio']:.2f} | "
            f"{c['roofline_fraction']:.3f} | "
            f"{'yes' if c['fits_hbm'] else 'NO'} |")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    cells = load_all(args.mesh)
    if args.json:
        print(json.dumps(cells, indent=1))
    else:
        print(markdown_table(cells))


if __name__ == "__main__":
    main()
