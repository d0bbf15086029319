#!/usr/bin/env python3
"""Time ``decode_attention`` of several checkouts on one card, at
Llama-3-8B's served decode shapes, with ``chip_smoke.py``'s clocks.

    python3 chip_ab.py <parent checkout>/src src src <parent checkout>/src

Each argument is a directory that holds a ``repro_torch`` package. Each runs
in a process of its own: its kernel is built, held against its plain
version (``chip_smoke.max_err`` and ``seq_err``), and timed eager and from a
CUDA graph beside SDPA, both ways, and the bytes bound
(``chip_smoke.decode_times``). Listing the trees as parent, change, change,
parent shows the card's drift within the call. One JSON line per (tree,
shape); a kernel that disagrees with its plain version exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((None, 4096), (4096, 8000))  # (window, longest length) at W = 4096


def one(src: Path):
    import chip_smoke as cs  # puts this checkout's src first on sys.path
    sys.path.insert(0, str(src))
    import torch
    import repro_torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        cs.fail(f"imported {repro_torch.__file__}, not the package under {src}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, W, H, KV, D, bf16 = 8, 4096, 32, 8, 128, torch.bfloat16
    for window, top in SHAPES:
        q = cs.randn((B, 1, H, D), bf16, gen)
        kc, vc = cs.randn((B, W, KV, D), bf16, gen), cs.randn((B, W, KV, D), bf16, gen)
        lengths = torch.linspace(1, top, B).round().int().cuda()
        kernel = lambda: decode_attention(q, kc, vc, lengths, window=window)
        out = kernel()
        ref = decode_attention_reference(
            q.reshape(B, KV, H // KV, D), kc.transpose(1, 2), vc.transpose(1, 2),
            lengths, window=window).reshape(B, 1, H, D)
        row = dict(src=str(src), window=window, lengths=lengths.tolist(),
                   max_abs_err=cs.max_err(out, ref, bf16),
                   seq_err=cs.seq_err(out, ref))
        row.update(cs.decode_times(kernel, q, kc, vc, lengths, window))
        print(json.dumps(row), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return one(Path(sys.argv[2]).resolve())
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        sys.exit("usage: chip_ab.py SRC [SRC ...] (on a machine with a card)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    code = 0
    for src in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", src], cwd=ROOT)
        code = code or res.returncode
    sys.exit(code)


if __name__ == "__main__":
    main()
