#!/usr/bin/env python3
"""Time kernels of several checkouts on one card, at the served shapes,
with ``chip_smoke.py``'s clocks.

    python3 chip_ab.py [--only flash,flash_bwd,flash_small,flash_small_f32,flash_f32,train_f32,decode,decode_f32,gla,microgrid,moe] <parent checkout>/src src src <parent checkout>/src

Each argument is a directory that holds a ``repro_torch`` package. Each runs
in a process of its own: its kernels are built, held against their plain
versions, and timed eager and from a CUDA graph beside their bound:
``flash_attention`` at the served head_dim 80 shapes (HuBERT-XLarge's
encoder B=4 S=1024 H=16 non-causal, phi-2's B=1 S=2048 MHA 32/32 causal,
h2o-danube-1.8b's B=1 S=2048 GQA 32/8 causal in its 4096 window) and, to
show what the shared template does to them, Zamba2's D=64 and Llama-3-8B's
D=128 rows at S=2048 (``chip_smoke.flash_case``, SDPA both ways),
``flash_attention_bwd`` at the bf16 training shapes of phase 3
(``chip_smoke.FLASH_BWD_SHAPES``: smollm-360m's B=8 S=2048 GQA 15/5 D=64,
Llama's widths, h2o-danube's D=80 window; ``flash_bwd_case``: held
against the plain backward, two launches bit-identical, eager and graph
ms, SDPA's backward), bf16 forward and backward at the small head dims
(``--only flash_small``: D = 16, 32 and 48 at ``chip_smoke.FLASH_SMALL``,
B=1 S=2048 GQA 32/8 causal, no served model; bound the larger of the
tensor cores' operations and one exp2 a visible pair
(``chip_smoke.exp2_ms``); the backward's device
time by kernel), the same in float32 (``--only flash_small_f32``: the
3xTF32 wgmma forward and backward, bound at 3xTF32 and at the FMA rate,
SDPA's float32 calls beside them), the float32 forward and backward (``--only
flash_f32``: ``chip_smoke.FLASH_F32_SHAPES``, smollm-360m's training shape,
Llama's widths and the small row, beside SDPA's float32 calls and both
bounds), phase 17d's float32 training steps (``--only train_f32``:
``chip_smoke.phase_train_f32``, its gates held), ``decode_attention`` at
Llama-3-8B's decode shapes (``chip_smoke.max_err``, ``seq_err`` and
``decode_times``, SDPA both ways), the float32-q decode at that shape
with a float32 and a bf16 cache (``--only decode_f32``:
``chip_smoke.decode_case``, device ms by kernel), and ``gla_scan`` at RWKV6-1.6B's prefill shapes (rwkv, H=32, T 128,
1000 and 2048) and Zamba2's widths (ssd, H=64, T=2048), bf16 q/k/v,
float32 log_w and u, and the float32 route at RWKV6's T=2048 and 128 and
Zamba2's widths with float32 q/k/v (``chip_smoke.GLA_TOL`` and
``gla_times``; device ms by kernel, ``chip_smoke.device_ms_by_kernel``; a
float32 row's error against a float64 scan, ``f64_err``, beside the float32
plain scan's), and
``microgrid_scan`` (``--only microgrid``) at Table 2's trace (T = 1800) and
a year at 60 s (T = 525,600), both under Table 2's battery: eager and graph
ms, the SM clock read while it runs, graph cycles a step at that clock,
and the serial chain's ms (``chip_smoke.microgrid_times``); both traces are
timed first, then held bit for bit against the plain step loop (Table 2's
on the card, the year's on the CPU, whose loop gives the card's bits:
``tests/test_torch_card.py::test_microgrid_loop_on_card_matches_cpu``),
so a scratch variant that computes less still prints its times before it
fails, and ``moe_dispatch`` and ``moe_combine`` (``--only moe``, a tree
that has them) at ``chip_smoke.MOE_SHAPES`` in bf16 beside their plain
versions and their bounds in bytes. ``--only`` picks some of the eleven (default: all). Listing
the trees as parent, change, change, parent shows the card's drift within
the call. One JSON line per (tree, shape); a kernel that disagrees with
its plain version exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((None, 4096), (4096, 8000))  # (window, longest length) at W = 4096
# (B, S, H, KV, D, causal, window): HuBERT, phi-2, h2o-danube, Zamba2, Llama
FLASH_SHAPES = ((4, 1024, 16, 16, 80, False, None), (1, 2048, 32, 32, 80, True, None),
                (1, 2048, 32, 8, 80, True, 4096), (1, 2048, 32, 32, 64, True, None),
                (1, 2048, 32, 8, 128, True, None))
GLA_SHAPES = (("rwkv", 32, 128, "bfloat16"), ("rwkv", 32, 1000, "bfloat16"),
              ("rwkv", 32, 2048, "bfloat16"), ("ssd", 64, 2048, "bfloat16"),
              ("rwkv", 32, 2048, "float32"), ("ssd", 64, 2048, "float32"),
              ("rwkv", 32, 128, "float32"))  # (mode, H, T, q/k/v) at B = 1, K = V = 64


KERNELS = ("flash", "flash_bwd", "flash_small", "flash_small_f32", "flash_f32",
           "train_f32", "decode", "decode_f32", "gla", "microgrid", "moe")


def one(src: Path, only):
    import chip_smoke as cs  # puts this checkout's src first on sys.path
    sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        cs.fail(f"imported {repro_torch.__file__}, not the package under {src}")
    for name in only:
        globals()[name](cs, src)


def flash(cs, src: Path):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, KV, D, causal, window in FLASH_SHAPES:
        row = dict(src=str(src), kernel="flash_attention", B=B, S=S, H=H, KV=KV,
                   D=D, causal=causal, window=window)
        row.update(cs.flash_case(B, S, H, KV, D, torch.bfloat16, causal, window,
                                 gen, timed=True))
        print(json.dumps(row), flush=True)


def flash_bwd(cs, src: Path):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key, (B, S, H, KV, D, dtype, causal, window) in cs.FLASH_BWD_SHAPES.items():
        row = dict(src=str(src), kernel="flash_attention_bwd", shape=key[10:], B=B,
                   S=S, H=H, KV=KV, D=D, dtype=str(dtype)[6:], causal=causal,
                   window=window)
        row.update(cs.flash_bwd_case(B, S, H, KV, D, dtype, causal, window, gen,
                                     timed=True))
        print(json.dumps(row), flush=True)


def flash_small(cs, src: Path, dtype_name="bf16"):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, KV = cs.FLASH_SMALL
    for D in cs.SMALL_D:
        for way in ("forward", "backward"):
            row = dict(src=str(src), kernel=f"flash_attention {dtype_name} {way}", B=B,
                       S=S, H=H, KV=KV, D=D, causal=True, window=None)
            if way == "forward":
                row.update(cs.flash_case(B, S, H, KV, D, dtype, True, None, gen,
                                         timed=True))
            else:
                row.update(cs.flash_bwd_case(B, S, H, KV, D, dtype, True, None, gen,
                                             timed=True, by_kernel=True))
            print(json.dumps(row), flush=True)


def flash_small_f32(cs, src: Path):
    flash_small(cs, src, "float32")


def flash_f32(cs, src: Path):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key, (B, S, H, KV, D, dtype, causal, window) in cs.FLASH_F32_SHAPES.items():
        for way, case in (("forward", cs.flash_case), ("backward", cs.flash_bwd_case)):
            row = dict(src=str(src), kernel=f"flash_attention float32 {way}", shape=key,
                       B=B, S=S, H=H, KV=KV, D=D, causal=causal, window=window)
            row.update(case(B, S, H, KV, D, dtype, causal, window, gen, timed=True))
            print(json.dumps(row), flush=True)


def train_f32(cs, src: Path):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(dict(src=str(src), kernel="phase 17d",
                          launches=cs.phase_train_f32())), flush=True)


def decode(cs, src: Path):
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
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


def decode_f32(cs, src: Path):
    """The float32-q decode at Llama-3-8B's decode shape (B=8 W=4096 H=32/8
    D=128, lengths 1..4096), with a float32 and with a bf16 cache:
    ``chip_smoke.decode_case`` (held to the plain version, eager and graph
    ms, SDPA, the bound, bytes/s) and the device ms of each kernel a call
    launches (two for a split-K kernel and its combine pass)."""
    import torch
    from repro_torch.kernels.decode_attention.ops import kernel_route
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, W, H, KV, D, f32 = 8, 4096, 32, 8, 128, torch.float32
    lengths = torch.linspace(1, W, B).round().int()
    for cache in (f32, torch.bfloat16):
        path = kernel_route(f32, cache, D)[0]
        row = dict(src=str(src), kernel="decode_attention float32 q", B=B, W=W,
                   H=H, KV=KV, D=D, cache=str(cache)[6:], lengths=lengths.tolist())
        row.update(cs.decode_case(B, W, H, KV, D, f32, lengths, None, gen,
                                  timed=True, cache_dtype=cache,
                                  by_kernel=1 if path == "bulk.fma" else 2))
        print(json.dumps(row), flush=True)


def gla_scan_f64(q, k, v, log_w, u, mode):
    """The token-by-token scan in float64 on the card, model layout: the
    yardstick of a float32 call's own error (``gla_scan_reference`` computes
    in float32)."""
    import torch
    q, k, v, log_w = (x.double() for x in (q, k, v, log_w))
    state = q.new_zeros(q.shape[0], q.shape[2], q.shape[3], v.shape[3])
    out = []
    for t in range(q.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        if mode == "rwkv":
            out.append(torch.einsum("bhk,bhkv->bhv", q[:, t],
                                    state + u.double()[None, :, :, None] * kv))
        state = torch.exp(log_w[:, t])[..., None] * state + kv
        if mode != "rwkv":
            out.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(out, 1), state


def gla(cs, src: Path):
    import torch
    from repro_torch.kernels.gla_scan import gla_scan, gla_scan_reference
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr = lambda x: x.transpose(1, 2)
    for mode, H, T, dtype_name in GLA_SHAPES:
        dtype = getattr(torch, dtype_name)
        q, k = cs.randn((1, T, H, 64), dtype, gen), cs.randn((1, T, H, 64), dtype, gen)
        v = cs.randn((1, T, H, 64), dtype, gen)
        log_w = cs.GLA_DECAYS["strong"](
            torch.rand((1, T, H, 64), generator=gen, device="cuda"))
        u = 0.3 * cs.randn((H, 64), torch.float32, gen) if mode == "rwkv" else None
        kernel = lambda: gla_scan(q, k, v, log_w, u=u, mode=mode)
        out, state = kernel()
        ref_o, ref_s = gla_scan_reference(tr(q), tr(k), tr(v), tr(log_w), u=u,
                                          mode=mode)
        row = dict(src=str(src), kernel="gla_scan", mode=mode, B=1, T=T, H=H,
                   K=64, V=64, dtype=dtype_name,
                   max_abs_err=max(cs.max_err(out, tr(ref_o), dtype, cs.GLA_TOL),
                                   cs.max_err(state, ref_s, dtype, cs.GLA_TOL)))
        if dtype == torch.float32:
            o64, s64 = gla_scan_f64(q, k, v, log_w, u, mode)
            err = lambda a, b: float((a.double() - b).abs().max())
            row.update(max_abs_ref=float(o64.abs().max()), f64_err=err(out, o64),
                       plain_f64_err=err(tr(ref_o), o64),
                       state_f64_err=err(state, s64), plain_state_f64_err=err(ref_s, s64))
        row.update(cs.gla_times(kernel, q, k, v, log_w, u, mode))
        row["by_kernel"] = cs.device_ms_by_kernel(kernel, 3)
        print(json.dumps(row), flush=True)


def microgrid(cs, src: Path):
    import torch
    from repro_torch.core.microgrid import constants
    from repro_torch.kernels.microgrid_scan import (microgrid_scan,
                                                    microgrid_scan_reference)
    k = constants(cs.microgrids()["table1b"])
    traces = {"table2": cs.table2_inputs(),
              "year": cs.microgrid_inputs(cs.MICROGRID_YEAR, 11)}
    for name, inputs in traces.items():
        T = inputs[0].shape[1]
        row = dict(src=str(src), kernel="microgrid_scan", trace=name, B=1, T=T)
        row.update(cs.microgrid_times(lambda: microgrid_scan(*inputs, k), T))
        row.update(cs.microgrid_bound(T))
        print(json.dumps(row), flush=True)
    for name, inputs in traces.items():
        dev = "cuda" if name == "table2" else "cpu"
        out = microgrid_scan(*inputs, k).cpu()
        ref = microgrid_scan_reference(*(x.to(dev) for x in inputs), k).cpu()
        equal = out.shape == ref.shape and cs.equal_nan(out, ref)
        print(json.dumps(dict(src=str(src), kernel="microgrid_scan", trace=name,
                              plain_on=dev, equal=equal)), flush=True)
        if not equal:
            cs.fail(f"microgrid_scan {name}: kernel differs from the plain loop")


def moe(cs, src: Path):
    """``moe_dispatch`` and ``moe_combine`` at ``chip_smoke.MOE_SHAPES``:
    ``chip_smoke.moe_case`` holds each to its plain version and times it
    eager and from a CUDA graph beside its bounds in bytes and the plain
    version's eager time, with the device ms of each kernel a call
    launches."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, arch, B, S in cs.MOE_SHAPES:
        for kernel, row in cs.moe_case(arch, B, S, gen, timed=True).items():
            print(json.dumps(dict(src=str(src), kernel=kernel, shape=label,
                                  B=B, S=S, **row)), flush=True)


def main():
    args = sys.argv[1:]
    only = KERNELS
    if args[:1] == ["--only"]:
        only = tuple(args[1].split(","))
        args = args[2:]
        if not only or not set(only) <= set(KERNELS):
            sys.exit(f"--only takes some of {','.join(KERNELS)}")
    if args[:1] == ["--one"]:
        return one(Path(args[1]).resolve(), only)
    import torch
    if not args or not torch.cuda.is_available():
        sys.exit(f"usage: chip_ab.py [--only {','.join(KERNELS)}] SRC [SRC ...] (on a "
                 "machine with a card)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    code = 0
    for src in args:
        res = subprocess.run([sys.executable, __file__, "--only", ",".join(only),
                              "--one", src], cwd=ROOT)
        code = code or res.returncode
    sys.exit(code)


if __name__ == "__main__":
    main()
