#!/usr/bin/env python3
"""Probe what holds the float32-q decode kernel (``decode_f32_kernel``, route
``bulk.fma``) back, on one card.

    python3 chip_decode_probe.py

Builds the library of ``src/repro_torch/kernels/decode_attention/csrc`` as it
stands and three variants of it, each compiled by hand with the flags of
``repro_torch.kernels._build`` into ``chip_scratch/decode_probe/``:

- ``no_compute``: the consumer warps wait for each tile and free it without
  computing (the output is garbage): the copy engine's stream and the CTAs'
  start, epilogue and combine alone;
- ``no_copies``: the producer arms each stage's barrier without asking for
  its bytes, and the consumers compute on whatever the stage holds: the
  compute, start, epilogue and combine alone;
- ``default_l2``: the cache's boxes loaded with the default L2 policy in
  place of ``evict_first``.

Each runs Llama-3-8B's decode shape (B=8 W=4096 H=32/8 D=128, lengths
1..4096) with a float32 and a bf16 cache, through ``ops.decode_attention``
with the library swapped in; it prints one JSON line per (variant, cache):
eager and CUDA-graph ms (``chip_smoke.time_ms`` / ``graph_ms``), and the
kernel and ``default_l2`` rows their max error against the plain version.
The last lines time PyTorch's sum over as many contiguous bytes (the stream
yardstick of ``chip_smoke.decode_times``). Variants run in the order given
and then in reverse, to show the card's drift.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
OUT = ROOT / "chip_scratch/decode_probe"
# text each variant replaces in the source, and with what
SCORES = "      // lane t scores slot ts + t for every head over the whole of D: K's"
COPIES = """    mbar_expect_tx(bar, L.mat);
    for (int x = 0; x < L.nb; ++x)
      tma_load(dst + x * F_BOX, prod ? &tv : &tk, bar, x * COLS, kvh, t0 + j * F_TS, b);"""
POLICY = ('"createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"',
          '"createpolicy.fractional.L2::evict_normal.b64 pol, 1.0;\\n"')
VARIANTS = {
    "kernel": [],
    "no_compute": [(SCORES, "      if (true) {  // free the stage untouched\n"
                            "        mbar_wait(full(1, cw), parity);\n"
                            "        __syncwarp();\n"
                            "        if (lane == 0) {\n"
                            "          mbar_arrive(empty(0, cw));\n"
                            "          mbar_arrive(empty(1, cw));\n"
                            "        }\n"
                            "        continue;\n"
                            "      }\n" + SCORES)],
    "no_copies": [(COPIES, "    (void)COLS;\n    mbar_arrive(bar);  // no bytes asked for")],
    "default_l2": [POLICY],
}


def build(name: str) -> Path:
    from repro_torch.kernels import _build
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to replace is not in {SOURCE}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    return so


def use(so: Path):
    """Point the wrapper at the library ``so``."""
    from repro_torch.kernels.decode_attention import ops
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                         ctypes.c_float, i, i, i, p]
    lib.decode_attention_fwd.restype = i
    lib.decode_attention_route.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.decode_attention_route.restype = ctypes.c_char_p
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    ops._LIB = lib
    ops.kernel_route.cache_clear()


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_decode_probe: no CUDA device; this script runs only on the card")
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_reference)
    print(cs.nvidia_smi("name,power.limit"))
    libs = {name: build(name) for name in VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, W, H, KV, D, f32 = 8, 4096, 32, 8, 128, torch.float32
    lengths = torch.linspace(1, W, B).round().int().cuda()
    inputs = {}
    for cache in (f32, torch.bfloat16):
        q = cs.randn((B, 1, H, D), f32, gen)
        kc, vc = cs.randn((B, W, KV, D), cache, gen), cs.randn((B, W, KV, D), cache, gen)
        ref = decode_attention_reference(q.reshape(B, KV, H // KV, D), kc.transpose(1, 2),
                                         vc.transpose(1, 2), lengths).reshape(B, 1, H, D)
        inputs[str(cache)[6:]] = (q, kc, vc, ref)
    names = list(VARIANTS)
    for name in names + names[::-1]:
        use(libs[name])
        for cache, (q, kc, vc, ref) in inputs.items():
            kernel = lambda: decode_attention(q, kc, vc, lengths)
            out = kernel()
            torch.cuda.synchronize()
            row = dict(variant=name, cache=cache, ms=cs.time_ms(kernel, 50),
                       graph_ms=cs.graph_ms(kernel))
            if name in ("kernel", "default_l2"):
                row["max_abs_err"] = float((out - ref).abs().max())
                if not row["max_abs_err"] <= 2e-5:
                    cs.fail(f"{name} ({cache} cache) disagrees with the plain version")
            print(json.dumps(row), flush=True)
    for cache, (_, kc, _, _) in inputs.items():
        nbytes = 2 * KV * D * float(lengths.sum()) * kc.element_size()
        x = torch.ones(int(nbytes) // 4, device="cuda")
        print(json.dumps(dict(stream=f"sum of {nbytes / 1e6:.2f} MB ({cache} cache's K and V)",
                              graph_ms=cs.graph_ms(lambda: x.sum()))), flush=True)


if __name__ == "__main__":
    main()
