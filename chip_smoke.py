#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero and prints no
result:

1. card: name and power limit (nvidia-smi), device name and count; TF32 off;
2. build: the four CUDA kernels with nvcc (``repro_torch.kernels._build``),
   with ptxas' registers, shared memory and spills per kernel, the kernel
   (and dynamic shared memory) that ``flash_attention``,
   ``decode_attention`` and ``gla_scan`` pick for each dtype and width, and
   the float32 flash kernels' tiles and ring depths at each head dim;
3. kernels against their plain PyTorch versions on the card: the
   ``tests/test_kernels.py`` sweeps (attention: float32 at 2e-5, bfloat16 at
   2e-2; gla_scan: 2e-4 and 5e-2, strong decay) and the served models' own
   shapes, each timed with CUDA events beside its bound, its plain version
   and, for attention, ``scaled_dot_product_attention`` (a yardstick the
   port never calls; no PyTorch call computes the GLA scan); every flash
   and decode case names the path that ran it (flash: ``wgmma`` or
   ``wgmma.3xtf32``; decode: ``mma.sync`` or ``fma``; a float32
   flash case is held against the plain version evaluated in float64) and
   every gla_scan case its route (``mma`` for bf16, ``mma.3xtf32`` for
   float32); the flash wgmma, decode mma.sync and gla_scan mma paths' own
   case lists run too (gla: strong, extreme and RWKV6-floor decays); the
   served attention and gla_scan shapes are also timed from a CUDA graph
   (device time without launch cost), every (K, V) that gla_scan
   instantiates runs once in each dtype, and each gla_scan row counts the
   exps its route takes and its device time by kernel
   (``torch.profiler``); each decode sequence is also held to its own
   output's scale (``seq_err``), and the served decode shapes run again
   with q x8; the float32 gla_scan route (3xTF32) runs at RWKV6's decay
   floor too (``clamp``: every token at -exp(10); ``floor``: the floor or
   a weak decay per token and channel) against the token-by-token scan at
   1e-3, at T = 1 and 65 on both sides of its 64-token chunk, and is
   timed at RWKV6's served shape (T = 2048 and 128) and Zamba2's (``ssd``,
   H = 64); ``microgrid_scan`` (the co-sim's steps in one
   launch) is held bit for bit against its plain step loop (Table 2's
   trace, seeded random loads under four batteries, no battery, a batch
   of traces, T = 0, one window and one step, three windows, signed zeros
   and a NaN in the surplus, a year at 60 s held against the loop on the
   host, whose float32 operations give the card's bits) and timed at Table 2's 1800
   steps and the year's 525,600 beside its bound and the serial chain's,
   with cycles a step at the SM clock read while it runs;
   flash attention's backward kernels (and the forward's lse) against the
   plain backward (``attention_backward_reference``) over the card tests'
   grid (float32 at 2e-4, bf16 at 2e-2 of each gradient's largest
   magnitude; two launches bit-identical), then timed at the bf16 training
   shapes (smollm-360m's, Llama's widths, h2o-danube's D=80 window) beside
   their bound, the plain backward and SDPA's backward; the
   forward at smollm-360m's H=15/KV=5; float32 forward and backward at
   smollm-360m's training shape, Llama's widths and the small row
   (``FLASH_F32_SHAPES``) beside SDPA's float32 calls, their bound at the
   3xTF32 rate and at float32's FMA rate; the small head dims (16, 32, 48,
   no served model) at B=1 S=2048 GQA 32/8 causal, forward and backward,
   bf16 (wgmma) and float32 (wgmma.3xtf32, both ways),
   each backward's device time by kernel; every bf16 flash row's bound is the
   larger of its tensor-core operations and its exp2 (one a visible pair,
   split between the special-function units and a cubic on the FMA
   pipes), both printed, with the special-function units' time alone and
   SDPA's backward timed from a CUDA graph too; and, for the next
   redesign's ranking, the float32 decode at Llama-3-8B's decode shape;
4. Llama-3-8B at full width served through the launcher
   (``repro_torch.launch.serve.main``);
5. the main path: Llama-3-8B at full width served by ``ServingEngine`` with
   16 prompts of 256-2048 tokens; launch counts must equal layers x prefills
   and layers x decode iterations;
6. full-width consistency: the engine's tokens against a hand-rolled
   prefill + decode loop at the engine's 8 rows, that loop's logits against
   the same decode at one row (``ROW_TOL``), and the kernel path's logits
   against the plain einsum path's;
7. where the time goes: device busy share and kernel time by name
   (``torch.profiler``) for one prefill and four decode iterations;
8-10. phases 5-7 for RWKV6-1.6B at full width: every prefill scan goes
   through ``gla_scan`` (24 launches per prefill), decode through the plain
   single-token step; phase 9 holds the kernel path against the plain
   chunked scan (``gla_chunked``), in bf16 and in float32 (the float32
   check's ``gla_scan`` launches printed: a check, not a served path);
11. the paper's simulated pipeline with its tensor work on the card:
   ``run_simulation(PAPER_DEFAULT)`` (Table 1a, host code), ``energy_report``
   (Eqs. 1-3), the Table 2 co-sim (the stage log's Eq. 5 load placed from
   hour 8 of a 30 h, 60 s window with idle fill; 600 W solar, seed 3,
   cloudiness 0.12; CI seed 4; the 100 Wh battery at SoC 20-80 %), a
   two-site fleet, and the roofline's torch backend over the trace's
   stages, each held against the same call on the CPU in this process
   (Eq. 1 quantities at 5e-6, the roofline at 1e-5, host columns bitwise);
   it prints the Table 2 metrics, wall times on the card and on the CPU,
   and the co-sim's device operations (one ``microgrid_scan`` launch, the
   trace holding it once);
12. the sweep engine: all twelve ``--smoke`` sweeps of
   ``repro_torch.sweep.scenarios`` in vectorized mode, and fig1, fig3,
   fig4, exp5 and perf in device mode, on the card and on the CPU in this
   process, held card against CPU with ``repro_torch.obs.diff`` (host
   columns bitwise, Eq. 1 and co-sim columns within ``DEVICE_MODE_RTOL``;
   a ``regression`` fails); it prints each sweep's scenarios, wall times
   and cells by contract;
13. Zamba2-1.2B at full width as phases 5-7 (``gla_scan`` in ``ssd`` mode
   38 times a prefill, attention 7 times per iteration); its Mamba2 layers
   have no residual, so its kernel-vs-plain and one-vs-8-row checks are
   held per layer on the same inputs (``LayerwiseGap``);
14. Qwen3-MoE-30B-A3B at full width as phases 5-7 (61 GB of weights), then
   Mixtral-8x22B at full width and 4 of its 56 layers, one 6000-token
   prompt past its 4096 window (flash's window mask, decode's ring); MoE
   kernel-vs-plain checks route the plain path as the kernel path
   (``SharedRoutes``);
15. Qwen2-VL-2B at full width as phases 5-7, and one prefill of patch
   embeddings on an M-RoPE (t, h, w) grid, kernel against plain;
16. HuBERT-XLarge's encoder at full width: one prefill of 4 x 1024 frame
   embeddings (flash non-causal at head_dim 80 on the wgmma route, 48
   launches), timed and held against the plain path; 16a: where that
   prefill's time goes (device busy and idle, launches, flash's share);
17. training: smollm-360m at its published widths (float32 masters, bf16
   compute) through ``repro_torch.launch.train.main``, 20 steps of
   SyntheticLM at seq 2048 batch 8, then a restart that resumes from the
   committed step 20 and runs to 24; the losses must be finite and fall by
   0.3 from the first five to the last five, flash's forward and backward
   launch once per layer and step, peak memory under 80 GB; it prints step
   ms, tokens/s, MFU and checkpoint write seconds. 17a holds one step's
   gradients through the kernels against the plain einsum path (B=1), 17b
   gradient accumulation 4 against 1, both per leaf within 5e-2 relative
   Frobenius; 17c: where a step's time goes (torch.profiler). 17d trains
   the same widths in float32 (``cfg.replace(dtype="float32")``, float32
   compute) through ``make_train_step``: 6 steps of SyntheticLM at seq 2048
   batch 8 (phase 17's), flash's float32 kernels once per layer and step both ways,
   finite losses, peak memory under 80 GB, one step's gradients through
   the kernels against the einsum path (B=1) per leaf within
   ``F32_GRAD_TOL`` and the loss within ``F32_LOSS_TOL``; it prints step ms,
   tokens/s and one profiled step's device busy share and attention share.
18. the physics-invariant auditor and the remote sweep backend on the card.
   18a: the ``fig1`` (16 requests), ``fleet`` and ``shift`` smoke sweeps in
   event-loop mode with ``repro_torch.obs.audit.AuditProbe``, on the card
   and on the CPU: records with the auditor bit-identical to those
   without, both reports clean with equal runs and checks (``eq45-closure``
   armed on shift); the day config of ``tests/test_audit.py`` on the card,
   clean with ``clock-monotonic`` and ``eq45-closure`` armed; and
   ``python -m repro_torch.sweep.cli fig1 --smoke --audit --torch-device
   cuda`` exits 0 with ``audit: clean``. 18b: two workers
   (``python -m repro_torch.sweep.worker``) spawned on the card over a fresh
   cache and queue run the full ``carbon`` sweep (vectorized: 48 co-sims,
   ``microgrid_scan`` in the workers) and the full ``perf`` sweep (device
   mode: 1056 scenarios, 12 trace groups) with ``verify_groups=1``: records
   bit-identical to the in-process card run's (whose ``microgrid_scan``
   launches are counted), a second run all cache hits, no expired lease or
   quarantine; it prints the workers' warm-up, each run's wall and shards.
   18c: a worker killed after one group (exit 17) on the card; its shard is
   reclaimed and re-run by a second card worker, and the records equal the
   in-process card run's with one cache file per key.

Every ``torch.profiler`` reading (phase 3's time by kernel, phases 7, 10,
11, 13a-17d) comes from a whole trace: every kernel launch and copy the
work issued has its device record (``profiled``). A trace that lost
records is taken again, up to five times; when none is whole, phase 3's
times by kernel and phases 7, 10 and 13a-16a print "not measured", and
phases 11, 17c and 17d fail.

The line before the last is a JSON object with one entry per kernel (its
launches summed over the served phases and training); the last line is ``{"ok": true,
"device": {...}}``. Weights are random, drawn on the card from a seeded
generator.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor-core rate
# H100 SXM per SM and clock (the CUDA programming guide's throughput table,
# compute capability 9.0): exp2 on the special-function units 16, float32
# add, multiply and FMA 128; 132 SMs at the 1.83 GHz that gives the bf16
# peak above
SM_CLOCKS_PER_S = 132 * 1.83e9
SFU_PER_CLOCK, FMA_PER_CLOCK = 16, 128
# An exp2 may instead run on the FMA pipes as a Cody-Waite cubic
# (FlashAttention-4's softmax): a round-to-integer add, two subtractions
# and three FMA (the exponent's shift and add go to the integer pipe). Each
# visible pair also takes at least two FMA-pipe instructions beside its
# exp2: the scaling FMA and the row sum's add (forward), the scaling FMA
# and dS's product (backward).
POLY_EXP2_FMAS, SOFTMAX_FMAS = 6, 2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
ARCH = "llama3-8b"
RWKV_ARCH = "rwkv6-1.6b"
ZAMBA_ARCH = "zamba2-1.2b"
MOE_ARCH = "qwen3-moe-30b-a3b"
MIXTRAL_ARCH = "mixtral-8x22b"
# 141 B parameters are 282 GB in bf16: 4 of Mixtral's 56 layers (10.4 B,
# 21 GB) fit the card beside a 6000-token prefill's activations
MIXTRAL_LAYERS = 4
MIXTRAL_PROMPT = 6000       # past the 4096-token window: the ring wraps
VLM_ARCH = "qwen2-vl-2b"
AUDIO_ARCH = "hubert-xlarge"
ATTN_KERNELS = ("flash_fwd", "decode_mma", "decode_split", "decode_combine")
# Zamba2's Mamba2 out_proj scale in phase 13's random weights (draw_weights)
MAMBA_OUT_SCALE = 2.0
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:99"
DECODE_REPLACES = "src/repro/kernels/decode_attention/kernel.py:86"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DECODE_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
GLA_REPLACES = "src/repro/kernels/gla_scan/kernel.py:103"
GLA_SOURCE = "src/repro_torch/kernels/gla_scan/csrc/gla_scan.cu"
# the wgmma flash paths' cases, as in tests/test_torch_card.py: bf16 and
# float32 (3xTF32) at every head dim
WGMMA_D = (64, 80, 96, 112, 128)
SMALL_D = (16, 32, 48)
FLASH_D = SMALL_D + WGMMA_D
WGMMA_S = (1, 63, 64, 127, 128, 129, 1000, 2048)
WGMMA_MASKS = ((True, None), (True, 64), (True, 1000), (False, None))
# the decode mma.sync path's cases, as in tests/test_torch_card.py: W = 1024,
# KV = 2, lengths on both sides of a warp tile (16), a CTA pass (64) and a
# split (128 at W = 1024 on 132 SMs), W itself, and wrapped rings
DECODE_W = 1024
DECODE_LENGTHS = ((1, None), (15, None), (17, None), (63, None), (65, None),
                  (127, None), (129, None), (1024, None), (1324, 1024),
                  (900, 500))
# the other head dims the mma.sync path takes, as in tests/test_torch_card.py
DECODE_OTHER_D = (16, 32, 48, 80, 96, 112)
DECODE_OTHER_LENGTHS = ((1, None), (17, None), (129, None), (1024, None),
                        (1324, 1024))
# the gla_scan bf16 (mma) path's cases, as in tests/test_torch_card.py
GLA_MMA_T = (1, 15, 16, 63, 64, 65, 1000, 2048)
GLA_MMA_KV = ((16, 16), (64, 64), (32, 64))
GLA_WIDTHS = (16, 32, 48, 64)   # K and V the library instantiates for bf16
# the chunk of the chunked form whose products gla_scan's operations bound
# counts: a definition of the work, the same for every kernel version (the
# kernels' own tiles come from the library, ops.chunk_tokens)
GLA_BOUND_CHUNK = 64
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
# decode: each sequence's worst error over its largest |output| (seq_err)
SEQ_TOL = 2e-2
# phases 6 and 9: one-row against 8-row decode logits, max|diff| over
# max|logit|. On an H100 the two row counts' first decode steps differed by
# 1.0e-2 (RWKV6; 1.2e-2 with the PR 12 gla_scan kernel) and 0 (Llama-3-8B)
ROW_TOL = 3e-2
# gla_scan: the tolerances of tests/test_kernels.py::test_gla_scan_sweep
GLA_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (5e-2, 5e-2)}
# phase 16's encoder prefill median (ms) when flash ran its mma.sync kernel
# at head_dim 80: two calls on one H100 80GB HBM3 at 700 W
HUBERT_MMA_SYNC_MS = (30.85, 41.03)
FLASH_BWD_REPLACES = ("src/repro/models/attention.py:172 (_flash_core's custom "
                      "VJP, _flash_bwd_padded)")
# phase 3's backward tolerance: of each gradient's largest magnitude (a
# gradient that cancels to rounding noise at 1e-2 of the largest of the
# three); lse's absolute tolerance
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# the backward's route at every head dim
BWD_ROUTE = {torch.float32: "wgmma.3xtf32", torch.bfloat16: "wgmma"}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# phase 17: smollm-360m trained at its published widths
TRAIN_ARCH = "smollm-360m"
TRAIN_SEQ, TRAIN_BATCH = 2048, 8
TRAIN_STEPS, RESTART_STEPS = 20, 24
TRAIN_MARGIN = 0.3          # tests/test_train_serve_integration.py:40
GRAD_TOL = 5e-2             # phase 17a/b: relative Frobenius per leaf
MFU_PEAK_FLOPS = 989.4e12   # H100 SXM dense bf16, for the training MFU
# phase 3's timed bf16 backward shapes, (B, S, H, KV, D, dtype, causal,
# window): smollm-360m's training, Llama's widths, h2o-danube's D=80 window
FLASH_BWD_SHAPES = {
    "flash_bwd_smollm": (TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64, torch.bfloat16, True, None),
    "flash_bwd_llama": (1, 2048, 32, 8, 128, torch.bfloat16, True, None),
    "flash_bwd_danube": (1, 6000, 32, 8, 80, torch.bfloat16, True, 4096)}
# float32 rows of phase 3 and chip_ab.py --only flash_f32, forward and
# backward: smollm-360m's training shape, Llama's widths, the small row
FLASH_F32_SHAPES = {
    "smollm": (TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64, torch.float32, True, None),
    "llama": (1, 2048, 32, 8, 128, torch.float32, True, None),
    "small": (1, 1024, 8, 2, 64, torch.float32, True, None)}
# phase 3's small head dims and chip_ab.py --only flash_small: (B, S, H, KV)
# of the rows at D = 16, 32 and 48, causal
FLASH_SMALL = (1, 2048, 32, 8)
# phase 17d: smollm-360m's widths trained in float32 at phase 17's batch
F32_TRAIN_STEPS = 6
F32_GRAD_TOL = 1e-4         # per leaf, relative Frobenius: the CPU parity tests'
F32_LOSS_TOL = 1e-5         # relative
MICROGRID_REPLACES = "src/repro/core/microgrid.py:45 (simulate, lax.scan)"
MICROGRID_SOURCE = "src/repro_torch/kernels/microgrid_scan/csrc/microgrid_scan.cu"
# dependent float32 operations that carry soc_wh from one step to the next:
# sub, max, mul, min, mul, add, sub (the kernel folds max_chg and max_dis_w
# into caps computed off the chain; min is associative)
MICROGRID_CHAIN_OPS = 7
MICROGRID_YEAR = 525600     # steps of a year at 60 s


def fail(msg: str):
    raise SystemExit(f"FAILED: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``iters`` calls: the device's time without the host's cost of each
    launch, which bounds ``time_ms`` for small kernels. ``stream``: the
    capture stream, the one an autograd backward's forward ran on (its
    backward ops run there)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5, warmup=1) / iters


def max_err(out, ref, dtype, tol=TOL) -> float:
    """Max |out - ref|; fails when any element is outside atol + rtol|ref|."""
    a, b = out.float(), ref.float()
    rtol, atol = tol[dtype]
    if not torch.isfinite(a).all():
        fail("kernel output is not finite")
    diff = (a - b).abs()
    if bool((diff > atol + rtol * b.abs()).any()):
        fail(f"kernel disagrees with its plain version: max err {diff.max():.3e}")
    return float(diff.max())


def seq_err(out, ref) -> float:
    """Worst over the sequences of max |out - ref| / max |ref| in that
    sequence; fails above SEQ_TOL. A decode output is a softmax-weighted
    mean of up to thousands of V rows, so at q x1 its values (~0.02 at 4096
    slots) lie below max_err's atol: this holds each sequence to its own
    scale, where a dropped split or a combine without its rescale shows."""
    a, b = out.float().flatten(1), ref.float().flatten(1)
    err = float(((a - b).abs().amax(1) / b.abs().amax(1)).max())
    if not err <= SEQ_TOL:
        fail(f"decode kernel disagrees with its plain version at its "
             f"sequence's scale: {err:.3e} of max |ref|")
    return err


def bound(flops: float, nbytes: float, dtype) -> tuple:
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tf32x3_bound(flops: float, nbytes: float) -> tuple:
    """A float32 product's bound at the card's fastest rate that keeps
    float32's precision, the tensor cores split three ways (3xTF32: three
    TF32 products a flop), or its bytes."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------------

def phase_card() -> dict:
    print("== phase 1: card")
    print("nvidia-smi name, power.limit:")
    print(nvidia_smi("name,power.limit"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{dev['kind']!r} x{dev['count']}; capability "
          f"{torch.cuda.get_device_capability(0)}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return dev


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import \
        kernel_route as decode_route
    from repro_torch.kernels.flash_attention.ops import kernel_route, tf32_plan
    from repro_torch.kernels.gla_scan.ops import kernel_route as gla_route
    print("== phase 2: build (nvcc, one process per kernel, in parallel)")
    t = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t:.1f} s "
          f"into {_build.BUILD_DIR}")
    regs = {}
    for name, b in built.items():
        fn, spills = None, ""
        for line in b.log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            if "spill" in line:
                spills = line.strip()
            if "warning" in line.lower():
                print(f"  {name}: {line.strip()}")
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and fn:
                regs[kernel_label(fn)] = (int(m.group(1)), int(m.group(2) or 0))
                print(f"  {name}: {kernel_label(fn)}: {m.group(1)} registers, "
                      f"{m.group(2) or 0} bytes static smem; {spills}")
        if "registers" not in b.log:
            print(f"  {name}: library reused from an earlier build, "
                  "ptxas output not recorded")
    for dtype, D in [(dt, D) for dt in (torch.bfloat16, torch.float32)
                     for D in FLASH_D]:
        path, smem = kernel_route(dtype, D)
        print(f"  flash_attention route {dtype} D={D}: {path}, {smem} bytes "
              "dynamic smem per CTA")
        path, smem = kernel_route(dtype, D, backward=True)
        print(f"  flash_attention_bwd route {dtype} D={D}: {path}, {smem} "
              "bytes dynamic smem in its larger CTA")
    for D in FLASH_D:
        print(f"  flash float32 (3xTF32) tiles D={D}: {tf32_plan(D)}")
    for qdt, cdt, D in [(torch.bfloat16, torch.bfloat16, 128),
                        (torch.bfloat16, torch.bfloat16, 64),
                        (torch.bfloat16, torch.bfloat16, 80),
                        (torch.bfloat16, torch.bfloat16, 32),
                        (torch.float32, torch.bfloat16, 128),
                        (torch.float32, torch.float32, 128)]:
        path, smem = decode_route(qdt, cdt, D)
        print(f"  decode_attention route q {qdt} cache {cdt} D={D}: {path}, "
              f"{smem} bytes dynamic smem per CTA")
    for dtype, K, V in [(dt, K, V) for dt in (torch.bfloat16, torch.float32)
                        for K, V in ((64, 64), (32, 64), (16, 16))]:
        path, smem = gla_route(dtype, K, V)
        out = ("gla_scan_chunk_output_kernel" if dtype == torch.bfloat16
               else "gla_scan_chunk_output_tf32_kernel") + f"<{K}, {V}>"
        ctas = (ctas_per_sm(*regs[out], smem, 128) if out in regs
                else "not recorded")
        print(f"  gla_scan route {dtype} K={K} V={V}: {path}, {smem} bytes "
              f"dynamic smem in its largest CTA ({out}), {ctas} of its CTAs "
              "(4 warps each) resident an SM by its registers and shared "
              "memory")


def ctas_per_sm(registers: int, static_smem: int, dynamic_smem: int,
                threads: int) -> int:
    """CTAs of ``threads`` one H100 SM holds at once, from a kernel's
    registers a thread (ptxas) and its shared memory: 65,536 registers
    allocated 256 at a time per warp, 233,472 bytes of shared memory with
    1 KB reserved per CTA, at most 64 warps and 32 CTAs."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-registers * 32 // 256) * 256) // warps
    by_smem = 233472 // (static_smem + dynamic_smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def kernel_label(mangled: str) -> str:
    """``_ZN<n>_GLOBAL__N_...22flash_fwd_wgmma_kernelILi128ELb0EE...`` ->
    ``flash_fwd_wgmma_kernel<128, 0>``: the last name of a mangled (possibly
    nested) function name and its integer and bool template arguments."""
    i = mangled.find("_Z")
    if i < 0:
        return mangled[:60]
    i += 3 if mangled[i + 2:i + 3] == "N" else 2
    names = []
    while (m := re.match(r"\d+", mangled[i:])):
        start = i + m.end()
        i = start + int(m.group())
        names.append(mangled[start:i])
    if not names:
        return mangled[:60]
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if not args:
        return names[-1]
    ints = re.findall(r"L[ib](\d+)E", args.group(1))
    return f"{names[-1]}<{', '.join(ints)}>"


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_case(B, S, H, KV, D, dtype, causal, window, gen, timed=False,
               amp=1):
    """``amp`` scales q: at 8 the scores (standard deviation 8) reach ~+-60."""
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import kernel_route
    q = randn((B, S, H, D), dtype, gen) * amp
    k, v = randn((B, S, KV, D), dtype, gen), randn((B, S, KV, D), dtype, gen)
    tr = lambda x: x.transpose(1, 2)
    plain = lambda: tr(attention_reference(tr(q), tr(k), tr(v), causal=causal,
                                           window=window))
    kernel = lambda: flash_attention(q, k, v, causal=causal, window=window)
    out = kernel()
    torch.cuda.synchronize()
    # a float32 kernel is held against the plain version on float64 inputs
    # (at scores of +-60 float32's own rounding of the plain version reaches
    # the tolerance)
    wide = (lambda x: x.double()) if dtype == torch.float32 else (lambda x: x)
    ref = tr(attention_reference(*(wide(tr(x)) for x in (q, k, v)),
                                 causal=causal, window=window))
    row = {"max_abs_err": max_err(out, ref, dtype),
           "path": kernel_route(dtype, D)[0]}
    if timed:
        qt, kt, vt = (tr(x).contiguous() for x in (q, k, v))
        mask = None
        if window is not None:   # SDPA has no window: the band as a mask
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] > pos[:, None] - window) & (
                pos[None, :] <= pos[:, None] if causal else True)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        pairs = H * B * visible_pairs(S, causal, window)
        flops = 4.0 * D * pairs
        nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * q.element_size()
        row.update(ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5),
                   library_ms=time_ms(library, 20), graph_ms=graph_ms(kernel),
                   library_graph_ms=graph_ms(library))
        flash_bound(row, flops, nbytes, pairs, dtype)
    return row


def flash_bound(row, flops, nbytes, exp2s, dtype):
    """A flash row's ``bound_ms``. bf16: the larger of the tensor cores'
    operations (``bound_ops_ms``), ``exp2s`` exp2 (``bound_exp2_ms``; one a
    visible pair, the least the softmax needs; ``exp2_ms``) and the bytes;
    ``bound_term`` names the larger (``bound_by`` keeps the contract's
    "operations" for exp2). ``sfu_exp2_ms`` beside: the same exp2 on the
    special-function units alone. float32: three TF32 products a flop
    (3xTF32), the FMA rate's time beside it (``bound_fma_ms``)."""
    if dtype == torch.float32:
        row["bound_fma_ms"] = bound(flops, nbytes, dtype)[0]
        row["bound_ms"], row["bound_by"] = tf32x3_bound(flops, nbytes)
        return
    terms = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "exp2": exp2_ms(exp2s), "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    row["bound_ops_ms"], row["bound_exp2_ms"] = terms["operations"], terms["exp2"]
    row["sfu_exp2_ms"] = exp2s / (SFU_PER_CLOCK * SM_CLOCKS_PER_S) * 1e3
    row["bound_term"] = max(terms, key=terms.get)
    row["bound_ms"] = terms[row["bound_term"]]
    row["bound_by"] = "bytes" if row["bound_term"] == "bytes" else "operations"


def exp2_ms(exp2s: float) -> float:
    """Least ms for ``exp2s`` exp2, each with SOFTMAX_FMAS other FMA-pipe
    instructions: a share ``f`` of the exp2 runs as the cubic on the FMA
    pipes and the rest on the special-function units, ``f`` chosen so that
    both finish together (or 0 when the FMA pipes bind without it)."""
    f = max(0.0, (FMA_PER_CLOCK / SFU_PER_CLOCK - SOFTMAX_FMAS)
            / (FMA_PER_CLOCK / SFU_PER_CLOCK + POLY_EXP2_FMAS))
    clocks = max((1 - f) / SFU_PER_CLOCK,
                 (SOFTMAX_FMAS + f * POLY_EXP2_FMAS) / FMA_PER_CLOCK)
    return exp2s * clocks / SM_CLOCKS_PER_S * 1e3


def visible_pairs(S: int, causal: bool, window) -> float:
    """(query, key) pairs the mask lets through in one (batch, head)."""
    qpos = torch.arange(S)
    n_keys = (qpos + 1) if causal else torch.full((S,), S)
    if window is not None:
        n_keys = torch.minimum(n_keys, torch.tensor(window))
    return float(n_keys.sum())


def flash_bwd_case(B, S, H, KV, D, dtype, causal, window, gen, timed=False,
                   amp=1, by_kernel=False):
    """The backward kernels (and the forward's lse) against their plain
    versions, fed the kernel forward's o and lse; two launches bit-identical.
    ``timed``: eager and graph ms, the bound (10 D flops and one exp2 per
    visible pair and head; bf16 rows also print ``design_exp2_ms``, the two
    exp2 a pair of the two kernels that each recompute P), the plain
    backward's ms and SDPA's backward alone (autograd.grad with
    retain_graph on one retained SDPA forward; eager and from a CUDA graph
    captured on the forward's stream); beside them the
    forward's eager ms without lse (serving's) and with it (training's);
    ``by_kernel``: the backward's device ms by kernel (``torch.profiler``)."""
    from repro_torch.kernels.flash_attention import (
        attention_backward_reference, attention_forward_reference,
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ops import kernel_route
    q = randn((B, S, H, D), dtype, gen) * amp
    k, v = randn((B, S, KV, D), dtype, gen), randn((B, S, KV, D), dtype, gen)
    do = randn((B, S, H, D), dtype, gen)
    tr = lambda x: x.transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    kernel = lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                         window=window)
    plain = lambda: attention_backward_reference(
        tr(q), tr(k), tr(v), tr(out), lse, tr(do), causal=causal, window=window)
    grads, again = kernel(), kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail("two backward launches on the same inputs differ")
    _, ref_lse = attention_forward_reference(tr(q), tr(k), tr(v), causal=causal,
                                             window=window)
    lse_err = float((lse - ref_lse).abs().max())
    if not lse_err <= LSE_TOL[dtype]:
        fail(f"forward lse differs from the plain version's by {lse_err:.3e}")
    refs = [tr(r).float() for r in plain()]
    largest = max(float(r.abs().max()) for r in refs)
    errs = []
    for name, got, want in zip("qkv", grads, refs):
        if not torch.isfinite(got).all():
            fail(f"d{name} is not finite")
        scale = max(float(want.abs().max()), 1e-2 * largest)
        errs.append(float((got.float() - want).abs().max()) / scale)
        if not errs[-1] <= BWD_TOL[dtype]:
            fail(f"backward d{name} disagrees with its plain version: "
                 f"{errs[-1]:.3e} of its largest magnitude")
    row = {"max_abs_err": max(float((g.float() - r).abs().max())
                              for g, r in zip(grads, refs)),
           "rel_err": errs, "lse_err": lse_err,
           "path": kernel_route(dtype, D, backward=True)[0]}
    if timed:
        qt, kt, vt = (tr(x).detach().contiguous().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if window is not None:   # SDPA has no window: the band as a mask
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] > pos[:, None] - window) & (
                pos[None, :] <= pos[:, None] if causal else True)
        fwd_stream = torch.cuda.Stream()   # SDPA's backward is captured there
        fwd_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(fwd_stream):
            sdpa = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        torch.cuda.current_stream().wait_stream(fwd_stream)
        g = tr(do).contiguous()
        library = lambda: torch.autograd.grad(sdpa, (qt, kt, vt), g,
                                              retain_graph=True)
        pairs = H * B * visible_pairs(S, causal, window)
        flops = 10.0 * D * pairs
        nbytes = ((4 * B * S * H * D + 4 * B * S * KV * D) * q.element_size()
                  + 2 * B * H * S * 4)    # q, o, do, dq; k, v, dk, dv; lse, delta
        row.update(ms=time_ms(kernel, 10), plain_ms=time_ms(plain, 3, warmup=1),
                   library_ms=time_ms(library, 10), graph_ms=graph_ms(kernel, 10),
                   library_graph_ms=graph_ms(library, 10, stream=fwd_stream),
                   fwd_ms=time_ms(lambda: flash_attention(
                       q, k, v, causal=causal, window=window), 20),
                   fwd_lse_ms=time_ms(lambda: flash_attention_fwd(
                       q, k, v, causal=causal, window=window), 20))
        flash_bound(row, flops, nbytes, pairs, dtype)
        if dtype == torch.bfloat16:
            row["design_exp2_ms"] = exp2_ms(2 * pairs)
        if by_kernel:
            row["by_kernel"] = device_ms_by_kernel(kernel, 3)
        del sdpa
    return row


def decode_case(B, W, H, KV, D, dtype, lengths, window, gen, timed=False,
                amp=1):
    """``amp`` scales q: at 8 the scores reach about +-40."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    from repro_torch.kernels.decode_attention.ops import kernel_route
    q = randn((B, 1, H, D), dtype, gen) * amp
    kc, vc = randn((B, W, KV, D), dtype, gen), randn((B, W, KV, D), dtype, gen)
    lengths = lengths.to(device="cuda", dtype=torch.int32)
    plain = lambda: decode_attention_reference(
        q.reshape(B, KV, H // KV, D), kc.transpose(1, 2), vc.transpose(1, 2),
        lengths, window=window).reshape(B, 1, H, D)
    kernel = lambda: decode_attention(q, kc, vc, lengths, window=window)
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    row = {"max_abs_err": max_err(out, ref, dtype),
           "seq_err": seq_err(out, ref),
           "path": kernel_route(dtype, dtype, D)[0]}
    if timed:
        row.update(decode_times(kernel, q, kc, vc, lengths, window))
        row["plain_ms"] = time_ms(plain, 10)
    return row


def decode_times(kernel, q, kc, vc, lengths, window) -> dict:
    """``kernel()``'s time eager (CUDA events over 50 calls) and from a CUDA
    graph, SDPA's both ways on the same inputs, and the bound of the bytes
    and operations of this call's valid slots. Model layout: q (B, 1, H, D),
    caches (B, W, KV, D)."""
    B, _, H, D = q.shape
    W, KV = kc.shape[1], kc.shape[2]
    n_valid = torch.clamp(lengths, max=min(W, window or W)).long()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    mask = (torch.arange(W, device="cuda")[None, :] < n_valid[:, None])[:, None, None]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    slots = float(n_valid.sum())
    flops = 4.0 * D * H * slots
    nbytes = (2 * KV * D * slots + 2 * B * H * D) * q.element_size() + 4 * B
    row = dict(ms=time_ms(kernel, 50), library_ms=time_ms(library, 50),
               graph_ms=graph_ms(kernel), library_graph_ms=graph_ms(library))
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, q.dtype)
    return row


# gla_scan decays per token, drawn on the card: the sweep's strong range
# (|log w| up to 12), an extreme one (up to 40), and RWKV6's floor of -22026
# (log w = -exp(10)) beside weak decays at random per token and channel
GLA_DECAYS = {
    "strong": lambda unif: -torch.exp(unif * 8.5 - 6.0),
    "extreme": lambda unif: -40.0 * unif,
    "floor": lambda unif: torch.where(unif < 0.5, -float(np.exp(10.0)),
                                      -torch.exp(unif * 12.0 - 12.0)),
    "clamp": lambda unif: torch.full_like(unif, -float(np.exp(10.0))),
}
# the float32 kernel at RWKV6's floor: the exact scan's tolerance there
# (tests/test_torch_gla_design.py::TOL), above the sweep's 2e-4
GLA_FLOOR_TOL = {torch.float32: (1e-3, 1e-3)}


def gla_case(B, T, H, K, V, mode, dtype, gen, lw_dtype=None, timed=False,
             decay="strong", tol=GLA_TOL):
    """gla_scan against its plain version (the token-by-token scan).
    ``lw_dtype``: the dtype of log_w and u (the sweep rounds them to
    ``dtype``; the model keeps them in float32). ``decay``: a key of
    GLA_DECAYS."""
    from repro_torch.kernels.gla_scan import gla_scan, gla_scan_reference
    from repro_torch.kernels.gla_scan.ops import kernel_route
    q, k = randn((B, T, H, K), dtype, gen), randn((B, T, H, K), dtype, gen)
    v = randn((B, T, H, V), dtype, gen)
    unif = torch.rand((B, T, H, K), generator=gen, device="cuda")
    log_w = GLA_DECAYS[decay](unif).to(lw_dtype or dtype)
    u = 0.3 * randn((H, K), lw_dtype or dtype, gen) if mode == "rwkv" else None
    tr = lambda x: x.transpose(1, 2)

    def plain():
        o, s = gla_scan_reference(tr(q), tr(k), tr(v), tr(log_w), u=u, mode=mode)
        return tr(o), s

    kernel = lambda: gla_scan(q, k, v, log_w, u=u, mode=mode)
    out, state = kernel()
    torch.cuda.synchronize()
    ref_o, ref_s = plain()
    path = kernel_route(dtype, K, V)[0]
    row = {"max_abs_err": max(max_err(out, ref_o, dtype, tol),
                              max_err(state, ref_s, dtype, tol)),
           "path": path}
    if timed:
        row.update(gla_times(kernel, q, k, v, log_w, u, mode))
        row["plain_ms"] = time_ms(plain, 1, warmup=1)
        row["exps"] = gla_exps(B, T, H, K, V, dtype)
        row["by_kernel"] = device_ms_by_kernel(kernel, 3)
    return row


def device_ms_by_kernel(fn, kernels: int, iters: int = 10) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, from a
    ``torch.profiler`` trace of ``iters`` calls (``profiled``) that holds
    each of the call's ``kernels`` kernels ``iters`` times; None when no
    trace was whole."""
    def whole(device):
        counts = {}
        for e in device:
            counts[kernel_name(e.name)] = counts.get(kernel_name(e.name), 0) + 1
        return len(counts) == kernels and set(counts.values()) == {iters}
    fn()
    torch.cuda.synchronize()
    traced = profiled(lambda: [fn() for _ in range(iters)],
                      f"{kernels} kernels x {iters} calls", whole)
    if traced is None:
        return None
    out = {}
    device = traced[0]
    for e in device:
        name = kernel_name(e.name)
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


def kernel_name(name: str) -> str:
    """``void gla_scan_state_prefix_kernel<64>(float*, ...)`` ->
    ``gla_scan_state_prefix_kernel``."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", name)
    return m.group(1) if m else name[:40]


# Host calls whose work the card records: each must find its device record,
# by correlation id, in a whole trace.
ISSUED = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy)")
PROFILE_ATTEMPTS = 5
PROFILE_PAD = 128


def profiled(fn, what: str, whole=lambda device: True):
    """(device events, traced wall ms) of one call of ``fn`` and the card's
    drain in a ``torch.profiler`` session (CPU and CUDA activity), or None.
    With torch 2.11 and CUDA 12.8 on the H100 of ``PERF.md``, the profiler
    loses device records of its sessions from 10-20 s after a process's
    first session on, whatever the process ran (``chip_profiler_probe.py``;
    ``PERF.md`` §6, PR 26): the first records of a session, or its last.
    So ``fn`` runs between ``PROFILE_PAD`` launches of ``torch.cuda._sleep``'s
    ``spin_kernel`` before it and as many after it (left out of what this
    returns), and a trace counts only when every kernel launch and copy
    that ``fn`` issued has its device record and ``whole(device)`` holds.
    It is taken again otherwise, up to ``PROFILE_ATTEMPTS`` sessions; when
    none is whole this prints what the last one lost and returns None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = prof.events()
        issued = sorted((e for e in events if e.device_type == DeviceType.CPU
                         and ISSUED.match(e.name)), key=lambda e: e.time_range.start)
        pad_ids = {e.id for e in issued[:PROFILE_PAD] + issued[-PROFILE_PAD:]}
        issued = issued[PROFILE_PAD:-PROFILE_PAD]
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        pad = [e for e in device if "spin_kernel" in e.name]
        device = [e for e in device if "spin_kernel" not in e.name]
        seen = {e.id for e in device}
        lost = [i for i, e in enumerate(issued) if e.id not in seen]
        apart = (all(e.id in pad_ids for e in pad)
                 and not any(e.id in pad_ids for e in device))
        if device and apart and not lost and whole(device):
            if attempt > 1:
                print(f"  ({what}: trace {attempt} of {PROFILE_ATTEMPTS} whole; "
                      "the profiler lost device records of the earlier ones)")
            return device, wall
    names = {}
    for e in device:
        names[kernel_name(e.name)] = names.get(kernel_name(e.name), 0) + 1
    print(f"  ({what}: not measured: none of {PROFILE_ATTEMPTS} profiler traces "
          f"whole; the last lost the device records of issued launches and "
          f"copies {lost} of 0..{len(issued) - 1}, kept {len(pad)} of "
          f"{2 * PROFILE_PAD} padding records (apart: {apart}) and "
          f"{len(device)} of the work's {names})")
    return None


def gla_exps(B, T, H, K, V, dtype) -> int:
    """Exps one gla_scan call takes on q/k/v of ``dtype``. Both routes (mma
    and mma.3xtf32) take, per chunk of the library's chunk tokens (64), ex2
    for the decayed k of the chunk state and of the off-diagonal sub-blocks
    and the decayed q (3 * 64 * K), the chunk decay (K), the
    run-of-sub-chunk factors (10 sets of 32 lanes x K / 4) and 6 pairs per
    lane of each warp's diagonal sub-block (4 x 32 x 6 x K)."""
    from repro_torch.kernels.gla_scan.ops import chunk_tokens
    c = chunk_tokens(dtype)
    per_chunk = 3 * c * K + K + 10 * 32 * K // 4 + 4 * 32 * 6 * K
    return B * H * -(-T // c) * per_chunk


def gla_times(kernel, q, k, v, log_w, u, mode) -> dict:
    """``kernel()``'s time eager (CUDA events over 20 calls) and from a CUDA
    graph, and the bound of this call's bytes (q, k, v, log_w and u read
    once, o and the final state written once) and operations (the chunked
    form's products at GLA_BOUND_CHUNK). Model layout. Needs nothing of the
    package, so that chip_ab.py can time older checkouts with it."""
    B, T, H, K = q.shape
    V = v.shape[3]
    c = GLA_BOUND_CHUNK
    pairs = c * (c - 1) // 2 if mode == "rwkv" else c * (c + 1) // 2
    flops = float(B * H * -(-T // c) * (2 * c * K * V * 2 + 2 * pairs * (K + V)))
    nbytes = ((2 * K + V) * q.element_size() + K * log_w.element_size()
              + V * v.element_size()) * B * T * H + 4 * B * H * K * V
    if u is not None:
        nbytes += u.numel() * u.element_size()
    row = dict(ms=time_ms(kernel, 20), library_ms=None, graph_ms=graph_ms(kernel))
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, q.dtype)
    return row


def fmt(row: dict) -> str:
    parts = [f"max_err={row['max_abs_err']:.3e}"]
    if "rel_err" in row:
        parts.append("rel_err(dq,dk,dv)=" + ",".join(
            f"{e:.2e}" for e in row["rel_err"]) + f" lse_err={row['lse_err']:.2e}")
    if "seq_err" in row:
        parts.append(f"seq_err={row['seq_err']:.3e}")
    if "path" in row:
        parts.insert(0, f"path={row['path']}")
    if "ms" in row:
        lib = row["library_ms"]
        parts += [f"ms={row['ms']:.4f}", f"plain_ms={row['plain_ms']:.4f}",
                  f"library_ms={'none' if lib is None else f'{lib:.4f}'}",
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})",
                  f"of_bound={row['bound_ms'] / row['ms']:.3f}"]
        if "bound_fma_ms" in row:
            parts.append(f"bound_fma_ms={row['bound_fma_ms']:.4f}")
        if "bound_exp2_ms" in row:
            parts.append(f"bound_term={row['bound_term']} "
                         f"bound_ops_ms={row['bound_ops_ms']:.4f} "
                         f"bound_exp2_ms={row['bound_exp2_ms']:.4f} "
                         f"sfu_exp2_ms={row['sfu_exp2_ms']:.4f}")
        if "design_exp2_ms" in row:
            parts.append(f"design_exp2_ms={row['design_exp2_ms']:.4f}")
    if "graph_ms" in row:
        parts.append(f"graph_ms={row['graph_ms']:.4f}")
        if "library_graph_ms" in row:
            parts.append(f"library_graph_ms={row['library_graph_ms']:.4f}")
        parts.append(f"graph_of_bound={row['bound_ms'] / row['graph_ms']:.3f}")
    if "fwd_lse_ms" in row:
        parts.append(f"fwd_ms={row['fwd_ms']:.4f} fwd_lse_ms={row['fwd_lse_ms']:.4f}")
    if "exps" in row:
        parts.append(f"exps={row['exps']}")
    if "by_kernel" in row:
        parts.append("by_kernel=" + (",".join(
            f"{name}:{ms:.4f}" for name, ms in row["by_kernel"].items())
            if row["by_kernel"] is not None else "not measured"))
    return " ".join(parts)


def phase_kernels() -> dict:
    print("== phase 3: kernels against their plain versions on the card "
          "(float32 tol 2e-5, bfloat16 tol 2e-2)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, KV, D in [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                               (1, 200, 8, 1, 32), (2, 64, 6, 3, 80)]:
            for causal, window in [(True, None), (True, 64), (False, None)]:
                row = flash_case(B, S, H, KV, D, dtype, causal, window, gen)
                print(f"flash sweep B={B} S={S} H={H} KV={KV} D={D} {dtype} "
                      f"causal={causal} window={window}: {fmt(row)}")
        for B, W, H, KV, D in [(2, 512, 8, 2, 64), (1, 1024, 4, 4, 128),
                               (3, 300, 6, 3, 80)]:
            lengths = torch.randint(1, W + 1, (B,), generator=gen, device="cuda")
            row = decode_case(B, W, H, KV, D, dtype, lengths, None, gen)
            print(f"decode sweep B={B} W={W} H={H} KV={KV} D={D} {dtype}: "
                  f"{fmt(row)}")
    print("-- flash, the wgmma paths' cases (tests/test_torch_card.py: bf16 "
          f"and float32 (3xTF32) at D {'/'.join(map(str, FLASH_D))}, H=8, GQA "
          "groups 1/4/8, B 1 and 2, causal / window 64 / window 1000 / "
          "non-causal, q x1 and x8), max error per (dtype, D, S)")
    for dtype in (torch.bfloat16, torch.float32):
        for D in FLASH_D:
            for S in WGMMA_S:
                worst, paths, n = 0.0, set(), 0
                for B in (1, 2):
                    for group in (1, 4, 8):
                        for causal, window in WGMMA_MASKS:
                            for amp in (1, 8):
                                row = flash_case(B, S, 8, 8 // group, D, dtype,
                                                 causal, window, gen, amp=amp)
                                worst = max(worst, row["max_abs_err"])
                                paths.add(row["path"])
                                n += 1
                print(f"flash wgmma cases {dtype} D={D} S={S}: {n} cases, "
                      f"path={'/'.join(sorted(paths))} max_err={worst:.3e}")
    print("-- decode, the mma.sync path's cases (tests/test_torch_card.py: "
          f"bf16, W={DECODE_W}, KV=2, B 1 and 8, q x1 and x8, G 1/2/4/8 at D "
          f"64/128 and G 1/8 at D {'/'.join(map(str, DECODE_OTHER_D))}; the "
          "first sequence at each length, the others at random), max error "
          f"per (D, length, window); seq_err held at {SEQ_TOL}")
    cases = [(D, length, window, (1, 2, 4, 8)) for D in (64, 128)
             for length, window in DECODE_LENGTHS]
    cases += [(D, length, window, (1, 8)) for D in DECODE_OTHER_D
              for length, window in DECODE_OTHER_LENGTHS]
    for D, length, window, groups in cases:
        worst, worst_seq, paths, n = 0.0, 0.0, set(), 0
        for G in groups:
            for B in (1, 8):
                for amp in (1, 8):
                    lengths = torch.randint(1, DECODE_W + 1, (B,),
                                            generator=gen, device="cuda")
                    lengths[0] = length
                    row = decode_case(B, DECODE_W, 2 * G, 2, D, torch.bfloat16,
                                      lengths, window, gen, amp=amp)
                    worst = max(worst, row["max_abs_err"])
                    worst_seq = max(worst_seq, row["seq_err"])
                    paths.add(row["path"])
                    n += 1
        print(f"decode mma.sync cases D={D} length={length} window={window}: "
              f"{n} cases, path={'/'.join(sorted(paths))} max_err={worst:.3e} "
              f"seq_err={worst_seq:.3e}")
    row = decode_case(2, 256, 4, 4, 64, torch.float32,
                      torch.tensor([256 + 57, 100]), 256, gen)
    print(f"decode ring B=2 W=256 window=256 lengths=[313, 100]: {fmt(row)}")

    print("-- the served model's shapes (Llama-3-8B: H=32 KV=8 D=128, bf16)")
    bf16 = torch.bfloat16
    rows = {}
    for S in (128, 1000, 2048):
        row = flash_case(1, S, 32, 8, 128, bf16, True, None, gen, timed=True)
        print(f"flash B=1 S={S} causal: {fmt(row)}")
        rows[f"flash_S{S}"] = row
    ragged = torch.linspace(1, 4096, 8).round().int()
    wrapped = torch.linspace(1, 8000, 8).round().int()
    for key, lengths, window in (("decode", ragged, None),
                                 ("decode_window", wrapped, 4096)):
        label = f"decode B=8 W=4096 window={window} lengths={lengths.tolist()}"
        row = decode_case(8, 4096, 32, 8, 128, bf16, lengths, window, gen,
                          timed=True)
        print(f"{label}: {fmt(row)}")
        rows[key] = row
        # scores ~8x larger: partials of different splits far apart in m, so
        # a combine that skipped a split or its rescale would show here
        row = decode_case(8, 4096, 32, 8, 128, bf16, lengths, window, gen,
                          amp=8)
        print(f"{label} q x8: {fmt(row)}")

    print("-- the other served families' attention shapes (bf16): HuBERT "
          "(non-causal, D=80), phi-2 (MHA 32/32, D=80) and h2o-danube (GQA "
          "32/8, D=80, window 4096) at S=2048, Mixtral (window 4096 at "
          "S=6000), Zamba2 (MHA 32/32, D=64); SDPA takes a window as a "
          "boolean mask")
    for key, args in (("hubert", (4, 1024, 16, 16, 80, bf16, False, None)),
                      ("phi2", (1, 2048, 32, 32, 80, bf16, True, None)),
                      ("danube", (1, 2048, 32, 8, 80, bf16, True, 4096)),
                      ("mixtral", (1, MIXTRAL_PROMPT, 48, 8, 128, bf16, True, 4096)),
                      ("zamba2", (1, 2048, 32, 32, 64, bf16, True, None))):
        row = flash_case(*args, gen, timed=True)
        B, S, H, KV, D, _, causal, window = args
        print(f"flash {key} B={B} S={S} H={H} KV={KV} D={D} causal={causal} "
              f"window={window}: {fmt(row)}")
    row = decode_case(8, 4096, 32, 32, 64, bf16, ragged, None, gen, timed=True)
    print(f"decode B=8 W=4096 H=32 KV=32 D=64 (Zamba2) lengths="
          f"{ragged.tolist()}: {fmt(row)}")
    row = flash_case(TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64, bf16, True, None, gen,
                     timed=True)
    print(f"flash smollm B={TRAIN_BATCH} S={TRAIN_SEQ} H=15 KV=5 D=64 causal "
          f"(phase 17's forward): {fmt(row)}")
    rows["flash_smollm"] = row
    rows.update(phase_flash_backward(gen))
    rows.update(flash_f32_rows(gen))
    rows.update(flash_small_rows(gen))
    rows.update(unranked_rows(gen))

    print("-- gla_scan: the tests/test_kernels.py sweep (float32 tol 2e-4, "
          "bfloat16 tol 5e-2; log_w in the input dtype, strong decay)")
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, K, V in [(1, 64, 2, 32, 32), (2, 130, 2, 64, 64),
                              (1, 256, 4, 16, 64)]:
            for mode in ("ssd", "rwkv"):
                row = gla_case(B, T, H, K, V, mode, dtype, gen)
                print(f"gla sweep B={B} T={T} H={H} K={K} V={V} {mode} "
                      f"{dtype}: {fmt(row)}")
    print("-- gla_scan float32 (mma.3xtf32) at RWKV6's floor, clamp and floor "
          "decays (tests/test_torch_card.py; tol 1e-3 against the "
          "token-by-token scan)")
    for B, T, H, K, V in [(1, 64, 2, 32, 32), (2, 130, 2, 64, 64),
                          (1, 256, 4, 16, 64), (1, 1000, 2, 64, 64),
                          (2, 65, 2, 64, 64), (2, 1, 2, 64, 64)]:
        for mode in ("ssd", "rwkv"):
            for decay in ("clamp", "floor"):
                row = gla_case(B, T, H, K, V, mode, torch.float32, gen,
                               decay=decay, tol=GLA_FLOOR_TOL)
                print(f"gla float32 {decay} B={B} T={T} H={H} K={K} V={V} "
                      f"{mode}: {fmt(row)}")
    print("-- gla_scan float32 (mma.3xtf32) on both sides of its 64-token "
          "chunk and at every (K, V) it instantiates (T=1 and 65, B=2, H=2, "
          "both modes, strong decay; tol 2e-4), max error per (K, V)")
    for K in GLA_WIDTHS:
        for V in GLA_WIDTHS:
            rows_kv = [gla_case(2, T, 2, K, V, mode, torch.float32, gen)
                       for T in (1, 65) for mode in ("ssd", "rwkv")]
            print(f"gla float32 width K={K} V={V}: path="
                  f"{'/'.join(sorted({r['path'] for r in rows_kv}))} max_err="
                  f"{max(r['max_abs_err'] for r in rows_kv):.3e}")
    print("-- gla_scan float32 (mma.3xtf32) at the served widths: RWKV6-1.6B "
          "(rwkv, H=32) at T=2048 and 128, Zamba2 (ssd, H=64) at T=2048; "
          "float32 q/k/v/log_w, strong decay")
    for key, (T, H, mode) in (("gla_f32_T2048", (2048, 32, "rwkv")),
                              ("gla_f32_T128", (128, 32, "rwkv")),
                              ("gla_f32_ssd", (2048, 64, "ssd"))):
        row = gla_case(1, T, H, 64, 64, mode, torch.float32, gen, timed=True)
        print(f"gla float32 {mode} B=1 T={T} H={H} K=V=64: {fmt(row)}")
        rows[key] = row
    print("-- gla_scan, the mma path's cases (tests/test_torch_card.py: bf16 "
          "q/k/v, H=2, B 1 and 2, both modes, float32 and bf16 log_w, strong / "
          "extreme / floor decays; tol 5e-2), max error per (T, K, V)")
    for T in GLA_MMA_T:
        for K, V in GLA_MMA_KV:
            worst, paths, n = 0.0, set(), 0
            for B in (1, 2):
                for mode in ("ssd", "rwkv"):
                    for lw_dtype in (torch.float32, bf16):
                        for decay in ("strong", "extreme", "floor"):
                            row = gla_case(B, T, 2, K, V, mode, bf16, gen,
                                           lw_dtype=lw_dtype, decay=decay)
                            worst = max(worst, row["max_abs_err"])
                            paths.add(row["path"])
                            n += 1
            print(f"gla mma cases T={T} K={K} V={V}: {n} cases, path="
                  f"{'/'.join(sorted(paths))} max_err={worst:.3e}")
    print("-- gla_scan, every (K, V) the library instantiates for bf16 "
          "(tests/test_torch_card.py: T=65, B=2, H=2, both modes, float32 and "
          "bf16 log_w, strong decay; tol 5e-2), max error per (K, V)")
    for K in GLA_WIDTHS:
        for V in GLA_WIDTHS:
            rows_kv = [gla_case(2, 65, 2, K, V, mode, bf16, gen, lw_dtype=lw)
                       for mode in ("ssd", "rwkv")
                       for lw in (torch.float32, bf16)]
            print(f"gla width K={K} V={V}: path="
                  f"{'/'.join(sorted({r['path'] for r in rows_kv}))} max_err="
                  f"{max(r['max_abs_err'] for r in rows_kv):.3e}")
    print("-- gla_scan at the served shapes (RWKV6-1.6B: H=32 K=V=64, bf16 "
          "q/k/v, float32 log_w and u; Zamba2 widths for ssd); no PyTorch call "
          "computes this scan, so library_ms is none")
    for T in (128, 1000, 2048):
        row = gla_case(1, T, 32, 64, 64, "rwkv", bf16, gen,
                       lw_dtype=torch.float32, timed=True)
        print(f"gla rwkv B=1 T={T} H=32 K=V=64: {fmt(row)}")
        rows[f"gla_T{T}"] = row
    row = gla_case(1, 2048, 64, 64, 64, "ssd", bf16, gen,
                   lw_dtype=torch.float32, timed=True)
    print(f"gla ssd B=1 T=2048 H=64 K=V=64 (Zamba2's served prefill): {fmt(row)}")
    rows.update(microgrid_cases())
    return rows


def phase_flash_backward(gen) -> dict:
    """Phase 3's backward part: the tests' grid, then the training shapes."""
    print("-- flash backward (tests/test_torch_card.py: bf16 wgmma and "
          "float32 wgmma.3xtf32 at every D; H=6, GQA groups 1/3/6, B=2, S "
          "1/63/65/127/128/129/200/257, causal / window 64 / window 100 / "
          "non-causal / non-causal window 50), worst error of each "
          "gradient's largest magnitude per (dtype, D); tol float32 2e-4, "
          "bf16 2e-2; lse float32 1e-5, bf16 1e-3; two launches "
          "bit-identical")
    for dtype in (torch.float32, torch.bfloat16):
        for D in (16, 32, 48, 64, 80, 96, 112, 128):
            worst, lse_worst, paths, n = 0.0, 0.0, set(), 0
            for S in (1, 63, 65, 127, 128, 129, 200, 257):
                for causal, window in ((True, None), (True, 64), (True, 100),
                                       (False, None), (False, 50)):
                    for KV in (6, 2, 1):
                        row = flash_bwd_case(2, S, 6, KV, D, dtype, causal,
                                             window, gen)
                        worst = max(worst, *row["rel_err"])
                        lse_worst = max(lse_worst, row["lse_err"])
                        paths.add(row["path"])
                        n += 1
            print(f"flash backward cases {dtype} D={D}: {n} cases, path="
                  f"{'/'.join(sorted(paths))} rel_err={worst:.3e} "
                  f"lse_err={lse_worst:.3e}")
            if paths != {BWD_ROUTE[dtype]}:
                fail(f"flash backward {dtype} D={D} ran {paths}, not "
                     f"{BWD_ROUTE[dtype]}")
    print("-- flash backward at the training shapes (smollm-360m's, Llama's "
          "widths, h2o-danube's D=80 with its 4096 window inside S=6000), "
          "bf16; library = SDPA's backward alone")
    rows = {}
    for key, args in FLASH_BWD_SHAPES.items():
        row = flash_bwd_case(*args, gen, timed=True)
        B, S, H, KV, D, dtype, causal, window = args
        print(f"flash backward {key[10:]} B={B} S={S} H={H} KV={KV} D={D} "
              f"{dtype} causal={causal} window={window}: {fmt(row)}")
        rows[key] = row
    return rows


def flash_f32_rows(gen) -> dict:
    """float32 forward and backward at FLASH_F32_SHAPES, timed beside SDPA's
    float32 calls and both bounds (3xTF32 and the FMA rate)."""
    print("-- flash float32 at smollm-360m's training shape, Llama's widths "
          "and the small row: forward (SDPA's forward beside it) and backward "
          "(SDPA's backward alone); bound_ms at three TF32 products a flop "
          "(3xTF32), bound_fma_ms at float32's FMA rate")
    rows = {}
    for key, args in FLASH_F32_SHAPES.items():
        B, S, H, KV, D, dtype, causal, window = args
        label = f"B={B} S={S} H={H} KV={KV} D={D} float32 causal={causal}"
        row = flash_case(*args, gen, timed=True)
        print(f"flash f32 forward {key} {label}: {fmt(row)}")
        rows[f"flash_f32_{key}"] = row
        row = flash_bwd_case(*args, gen, timed=True)
        print(f"flash f32 backward {key} {label}: {fmt(row)}")
        rows[f"flash_bwd_f32_{key}"] = row
    return rows


def flash_small_rows(gen) -> dict:
    """The head dims below 64 (no served model) at FLASH_SMALL, causal:
    bf16 forward and backward (the wgmma kernels) and float32 forward and
    backward (the wgmma.3xtf32 kernels), each beside SDPA's
    call in its dtype, each backward's device time by kernel beside it
    (delta, dK/dV, dQ)."""
    B, S, H, KV = FLASH_SMALL
    print(f"-- flash at the small head dims, B={B} S={S} H={H} KV={KV} causal: "
          "bf16 (bound_ms the larger of bound_ops_ms and bound_exp2_ms, "
          "bound_term the larger; the backward's design_exp2_ms: P computed "
          "by both kernels) and float32 "
          "(bound_ms at 3xTF32, bound_fma_ms at the FMA rate)")
    rows = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for D in SMALL_D:
            args = (B, S, H, KV, D, dtype, True, None)
            row = flash_case(*args, gen, timed=True)
            print(f"flash {name} D={D} forward: {fmt(row)}")
            rows[f"flash_{name}_d{D}"] = row
            row = flash_bwd_case(*args, gen, timed=True, by_kernel=True)
            print(f"flash {name} D={D} backward: {fmt(row)}")
            rows[f"flash_bwd_{name}_d{D}"] = row
    return rows


def unranked_rows(gen) -> dict:
    """Kernels timed here for their first rows in PERF.md: the float32 decode
    (split and combine) at Llama-3-8B's decode shape."""
    print("-- rows for the next redesign's ranking: float32 decode at B=8 "
          "W=4096 H=32 KV=8 D=128")
    rows = {}
    ragged = torch.linspace(1, 4096, 8).round().int()
    row = decode_case(8, 4096, 32, 8, 128, torch.float32, ragged, None, gen,
                      timed=True)
    print(f"decode float32 B=8 W=4096 H=32 KV=8 D=128 lengths="
          f"{ragged.tolist()}: {fmt(row)}")
    rows["decode_f32"] = row
    return rows


def equal_nan(a, b) -> bool:
    """``torch.equal`` with NaN equal to NaN (in the same places)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
        torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)))


def microgrid_inputs(T: int, seed: int, B: int = 1):
    """Seeded random (B, T) load, solar and CI traces on the card, as
    ``tests/test_torch_core.py::_grid_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    draw = lambda lo, hi: torch.as_tensor(
        rng.uniform(lo, hi, (B, T)), dtype=torch.float32, device="cuda")
    return draw(0, 600.0), draw(0, 800.0), draw(50, 800.0)


def signed_zero_inputs(T: int, seed: int):
    """``microgrid_inputs`` with signed zeros and a NaN placed in the
    surplus: every 7th step solar -0 against load +0 (surplus -0), every
    11th load -0 against solar +0 (surplus +0), every 13th both +0, and a
    NaN load 100 steps before the end (NaN from there on). The kernel's
    reordered chain must give the loop's values here too."""
    load, solar, ci = microgrid_inputs(T, seed)
    for every, ld, sol in ((7, 0.0, -0.0), (11, -0.0, 0.0), (13, 0.0, 0.0)):
        load[:, ::every], solar[:, ::every] = ld, sol
    load[:, T - 100] = float("nan")
    return load, solar, ci


def table2_inputs():
    """Table 2's co-sim inputs as ``core.run_cosim`` hands them to the
    scan (the stage log of ``run_simulation(PAPER_DEFAULT)`` as a 60 s
    load, solar and CI on its grid), from a CPU run, and its config."""
    from repro_torch import sim
    res = sim.run_simulation(sim.PAPER_DEFAULT)
    cos = table2_cosim(res, "cpu")
    return [torch.as_tensor(np.asarray(x, np.float32)[None], device="cuda")
            for x in (cos.load.values, cos.solar.values, cos.ci.values)]


def microgrids() -> dict:
    """The co-sim configurations the microgrid cases take: the default,
    Table 1b's 100 Wh battery at SoC 20-80 % (Table 2's), a slow 5-minute
    grid, no battery, and zero charge and discharge rates (caps of zero)."""
    from repro_torch import core
    battery = lambda **kw: core.MicrogridConfig(battery=core.BatteryConfig(**kw))
    return {"default": core.MicrogridConfig(),
            "table1b": battery(capacity_wh=100.0, soc_init=0.5, soc_min=0.2,
                               soc_max=0.8),
            "slow-5min": core.MicrogridConfig(
                step_s=300.0, battery=core.BatteryConfig(
                    capacity_wh=500.0, soc_init=0.2, max_charge_w=150.0,
                    max_discharge_w=90.0, efficiency=0.9)),
            "no-battery": battery(capacity_wh=0.0),
            "zero-rates": battery(max_charge_w=0.0, max_discharge_w=0.0)}


def sm_clock_during(fn) -> float:
    """The SM clock (MHz) that nvidia-smi reads while ``fn`` runs again and
    again on the card."""
    import threading
    got = []
    reader = threading.Thread(target=lambda: got.append(nvidia_smi("clocks.sm")))
    reader.start()
    while reader.is_alive():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    reader.join()
    return float(got[0].split()[0])


def microgrid_times(kernel, T: int) -> dict:
    """A microgrid_scan call over T steps: eager and CUDA-graph ms, the SM
    clock read while it runs (``sm_mhz``, beside ``max_sm_mhz``), graph
    cycles a step at that clock, and ``chain_ms``: the serial chain's
    MICROGRID_CHAIN_OPS dependent operations a step at ~4 cycles each, at
    the card's maximum SM clock."""
    long = T > 100_000
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    row = {"ms": time_ms(kernel, 5 if long else 50),
           "graph_ms": graph_ms(kernel, iters=4 if long else 20),
           "sm_mhz": sm_clock_during(kernel), "max_sm_mhz": max_mhz,
           "chain_ms": T * MICROGRID_CHAIN_OPS * 4 / (max_mhz * 1e3)}
    row["cycles_per_step"] = row["graph_ms"] * row["sm_mhz"] * 1e3 / T
    return row


def microgrid_bound(T: int) -> dict:
    """Bytes (three float32 inputs read and seven traces written once a
    step) against operations (~25 float32 a step) at the card's rates."""
    nbytes, flops = 4 * T * (3 + 7), 25 * T
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = ((t_ops, "operations") if t_ops >= t_bytes
                          else (t_bytes, "bytes"))
    return {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def microgrid_cases() -> dict:
    """``microgrid_scan`` against its plain step loop on the card, held
    with ``equal_nan`` (bit for bit): Table 2's trace, seeded random
    loads under four batteries, no battery, a batch of traces, T = 0, one
    window and one step, three windows, signed zeros and a NaN in the
    surplus, and a year at 60 s. Returns the Table 2 row and the year's,
    timed."""
    from repro_torch.core.microgrid import constants
    from repro_torch.kernels.microgrid_scan import (microgrid_scan,
                                                    microgrid_scan_reference)
    from repro_torch.kernels.microgrid_scan.ops import window_steps
    print("-- microgrid_scan against its plain step loop (torch.equal, NaN "
          "in the same places); no PyTorch call computes this scan, so "
          "library_ms is none")
    grids = microgrids()
    window = window_steps()

    def case(label, inputs, cfg, plain_on="cuda"):
        k = constants(cfg)
        n0 = microgrid_scan.launches
        out = microgrid_scan(*inputs, k)
        torch.cuda.synchronize()
        launched = microgrid_scan.launches - n0
        if launched != (1 if out.numel() else 0):
            fail(f"microgrid_scan {label}: {launched} launches")
        t = time.perf_counter()
        ref = microgrid_scan_reference(*(x.to(plain_on) for x in inputs), k)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        out = out.to(plain_on)
        if out.shape != ref.shape or not equal_nan(out, ref):
            diff = (out - ref).abs().nan_to_num(float("inf"))
            fail(f"microgrid_scan {label}: kernel differs from the plain loop "
                 f"(max |diff| {float(diff.max(initial=0.0)):.3e})")
        print(f"microgrid {label}: B={inputs[0].shape[0]} "
              f"T={inputs[0].shape[1]} equal=True launches={launched} "
              f"plain_on={plain_on} nan_soc={bool(torch.isnan(out[0]).any())}")
        return k, plain_s

    t2 = table2_inputs()
    k, _ = case("table2", t2, grids["table1b"])
    for seed in range(2):
        for name in ("default", "table1b", "slow-5min", "no-battery"):
            case(f"random seed={seed} {name}", microgrid_inputs(1800, seed),
                 grids[name])
    case("batch of 3", microgrid_inputs(window + 5, 7, B=3), grids["default"])
    case("T=0", microgrid_inputs(0, 0), grids["table1b"])
    case(f"T={window}+1 (a one-step tail)", microgrid_inputs(window + 1, 12),
         grids["default"])
    case(f"T=2x{window}+123 (three windows)",
         microgrid_inputs(2 * window + 123, 9), grids["default"])
    case(f"T=2x{window}+123 no battery",
         microgrid_inputs(2 * window + 123, 10), grids["no-battery"])
    for name in ("table1b", "zero-rates"):
        case(f"signed zeros and NaN {name}", signed_zero_inputs(1800, 13),
             grids[name])
    year = microgrid_inputs(MICROGRID_YEAR, 11)
    # the plain loop over a year runs once, on the host (minutes on the
    # card, where each step is a handful of tiny launches); its float32
    # operations give the card's bits
    # (tests/test_torch_card.py::test_microgrid_loop_on_card_matches_cpu)
    _, year_plain_s = case("year", year, grids["table1b"], plain_on="cpu")

    rows = {}
    for key, inputs in (("microgrid", t2), ("microgrid_year", year)):
        T = inputs[0].shape[1]
        kernel = lambda: microgrid_scan(*inputs, k)
        row = {"max_abs_err": 0.0, "path": "cuda",
               **microgrid_times(kernel, T), **microgrid_bound(T)}
        # the year's plain loop ran on the host: no device time of it
        row["plain_ms"] = float("nan") if key == "microgrid_year" else \
            time_ms(lambda: microgrid_scan_reference(*inputs, k), 2, warmup=1)
        host = (f" plain loop on the host {year_plain_s:.1f} s"
                if key == "microgrid_year" else "")
        print(f"{key} B=1 T={T}: {fmt(row)} chain_ms={row['chain_ms']:.4f} "
              f"cycles_per_step={row['cycles_per_step']:.1f} at "
              f"{row['sm_mhz']:.0f} MHz (max {row['max_sm_mhz']:.0f}){host}")
        rows[key] = row
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: full-width serving
# ---------------------------------------------------------------------------

def kernel_wrappers() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.gla_scan import gla_scan
    from repro_torch.kernels.microgrid_scan import microgrid_scan
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention, "gla_scan": gla_scan,
            "microgrid_scan": microgrid_scan}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def expected_launches(cfg) -> tuple:
    """({kernel: launches per prefill}, {kernel: launches per decode
    iteration}) of a model of ``cfg``: attention once per layer (Zamba2:
    once per shared-block application) and the GLA scan once per recurrent
    layer; an encoder has no decode."""
    from repro_torch.models.zamba import n_shared_applications
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"gla_scan": L}, {}
    if cfg.family == "hybrid":
        n_app = n_shared_applications(cfg)
        return {"gla_scan": L, "flash_attention": n_app}, {"decode_attention": n_app}
    return ({"flash_attention": L},
            {} if cfg.is_encoder_only else {"decode_attention": L})


def check_counts(cfg, n_pre: int, n_dec: int = 0) -> dict:
    """Every kernel's launches since ``reset_counts`` against
    ``expected_launches(cfg)`` for ``n_pre`` prefills and ``n_dec`` decode
    iterations: each kernel of the path launched, every other never."""
    per_prefill, per_decode = expected_launches(cfg)
    got = {name: fn.launches for name, fn in kernel_wrappers().items()}
    want = dict.fromkeys(got, 0)
    for name, n in per_prefill.items():
        want[name] += n * n_pre
    for name, n in per_decode.items():
        want[name] += n * n_dec
    print(f"launches {got}; expected {want} ({per_prefill} x {n_pre} "
          f"prefills, {per_decode} x {n_dec} decode iterations)")
    on_path = [k for k in per_prefill if n_pre] + [k for k in per_decode if n_dec]
    if got != want or not on_path or not all(got[k] for k in on_path):
        fail(f"launch counts {got} != expected {want}")
    return got


def check_engine_counts(engine) -> dict:
    return check_counts(engine.model.cfg,
                        sum(l.kind == "prefill" for l in engine.logs),
                        sum(l.kind == "decode" for l in engine.logs))


def check_done(done, n_requests: int, new_tokens: int, vocab: int):
    if len(done) != n_requests:
        fail(f"{len(done)} of {n_requests} requests finished")
    for r in done:
        if len(r.generated) != new_tokens or not all(0 <= t < vocab for t in r.generated):
            fail(f"request {r.rid}: bad tokens {r.generated}")


def phase_launcher():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    print("== phase 4: full-width serve through the launcher")
    argv = ["--arch", ARCH, "--no-reduced", "--slots", "8", "--max-len",
            "4096", "--requests", "16", "--new-tokens", "32"]
    print("repro_torch.launch.serve.main", argv)
    reset_counts()
    out = serve.main(argv, device="cuda")
    cfg = get_config(ARCH)
    check_done(out["engine"].done, 16, 32, cfg.vocab_size)
    check_engine_counts(out["engine"])
    del out
    gc.collect()
    torch.cuda.empty_cache()


def phase_engine(model, params, phase, lens=None, new_tokens: int = 32,
                 max_len: int = 4096) -> dict:
    """The model served by ``ServingEngine`` at 8 slots: by default 16
    prompts of 256-2048 tokens (seeded), 32 new tokens each."""
    from repro_torch.launch.serve import energy_report
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    cfg = model.cfg
    rng = np.random.default_rng(0)
    if lens is None:
        lens = rng.integers(256, 2049, 16)
    lens = np.asarray(lens)
    print(f"== phase {phase}: full-width {cfg.name} ServingEngine, "
          f"{len(lens)} prompts of {lens.min()}-{lens.max()} tokens, "
          f"{new_tokens} new tokens each, 8 slots, max_len {max_len}")
    engine = ServingEngine(model, params, max_slots=8, max_len=max_len,
                           device="cuda")
    for i, n in enumerate(lens):
        engine.submit(ServeRequest(rid=i, prompt=rng.integers(1, cfg.vocab_size, n),
                                   max_new_tokens=new_tokens))
    print(f"prompt lengths {lens.tolist()}")
    print(f"before: nvidia-smi clocks.sm, power.draw: "
          f"{nvidia_smi('clocks.sm,power.draw')}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    done = engine.run()
    torch.cuda.synchronize()
    counts = check_engine_counts(engine)
    print(f"after: nvidia-smi clocks.sm, power.draw: "
          f"{nvidia_smi('clocks.sm,power.draw')}")
    check_done(done, len(lens), new_tokens, cfg.vocab_size)
    toks = sum(len(r.generated) for r in done)
    pre = [l.dur_s for l in engine.logs if l.kind == "prefill"]
    dec = [l.dur_s for l in engine.logs if l.kind == "decode"]
    print(f"{len(done)} requests, {toks} generated tokens, "
          f"{int(lens.sum())} prompt tokens, engine clock {engine.clock:.3f} s, "
          f"{toks / engine.clock:.1f} generated tok/s")
    print(f"prefill iterations {len(pre)}: median {np.median(pre) * 1e3:.2f} ms; "
          f"decode iterations {len(dec)}: median {np.median(dec) * 1e3:.2f} ms")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    wh, rep, prof = energy_report(engine, cfg, "h100", 400.0)
    print(f"Eq. 1/3 energy {wh * 1000:.3f} mWh, Eq. 4 carbon "
          f"{rep.total_g:.5f} gCO2 (operational {rep.operational_g:.5f}, "
          f"embodied {rep.embodied_g:.5f}; CI=400, profile {prof.name})")
    return counts


def phase_consistency(model, params, phase: int):
    from repro_torch.kernels.gla_scan import gla_scan
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    cfg = model.cfg
    print(f"== phase {phase}: full-width {cfg.name} consistency")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, 512)
    engine = ServingEngine(model, params, max_slots=8, max_len=4096,
                           device="cuda")
    engine.submit(ServeRequest(rid=0, prompt=prompt, max_new_tokens=8))
    engine_tokens = engine.run()[0].generated
    # The hand-rolled loop prefills the prompt alone (a fresh cache of one
    # row), places that cache in row 0 of a cache of the engine's 8 slots
    # and decodes all 8 rows as the engine does (the others idle, token 0):
    # its greedy tokens must equal the engine's. Beside it the same cache of
    # one row decodes alone, fed the 8-row loop's tokens, and its logits are
    # held to the 8-row loop's at every step: max|diff| / max|logit| at most
    # ROW_TOL. The plain bf16 decode does not round alike at 1 and 8 rows
    # (cuBLAS picks other kernels), so a random model's greedy argmax can
    # turn on a one-ulp tie and the tokens are not compared across row
    # counts (PERF.md); a fault that mixes or misplaces rows moves logits by
    # O(1) of their scale.
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    logits, solo_cache = model.prefill(params, {"tokens": tokens}, 4096)
    cache = model.init_cache(8, 4096, device="cuda")
    for key, x in solo_cache.items():
        (cache[key][0:1] if key == "lengths" else cache[key][:, 0:1]).copy_(x)
    ref = [int(torch.argmax(logits[0]))]
    gaps, solo = [], []
    # Zamba2: each layer also runs on row 0 alone, held per layer (chaotic)
    rows = LayerwiseGap(one_row) if cfg.family == "hybrid" else None
    for _ in range(7):
        batch = torch.zeros((8, 1), dtype=torch.long, device="cuda")
        batch[0, 0] = ref[-1]
        decoder = rows.wrap(model) if rows else model
        logits, cache = decoder.decode_step(params, {"tokens": batch}, cache)
        solo_logits, solo_cache = model.decode_step(
            params, {"tokens": torch.tensor([[ref[-1]]], device="cuda")},
            solo_cache)
        a, b = logits[0].float(), solo_logits[0].float()
        gaps.append(float((a - b).abs().max() / a.abs().max()))
        ref.append(int(torch.argmax(a)))
        solo.append(int(torch.argmax(b)))
    print(f"engine tokens {engine_tokens}; hand-rolled at 8 rows {ref}")
    print(f"one row vs 8 rows, fed the same tokens: max|diff| / max|logit| "
          f"per step {', '.join(f'{g:.3e}' for g in gaps)} (tol {ROW_TOL:.0e}); "
          f"argmax at one row {solo} (not held)")
    if engine_tokens != ref:
        fail("engine tokens differ from the hand-rolled prefill + decode loop")
    if rows:
        # the end-to-end logits are printed above, not held (LayerwiseGap)
        rows.check("one row vs 8 rows", ROW_TOL)
    elif not max(gaps) <= ROW_TOL:
        fail(f"decode logits at one row and at 8 rows differ by "
             f"{max(gaps):.3e} of their scale")
    del engine, cache, solo_cache

    # Kernel path against the plain einsum path over one prefill and four
    # decode steps, both fed the kernel path's greedy tokens. Tolerance: 5e-2
    # of the largest logit. Both paths keep bf16 activations (one rounding
    # step is 3.9e-3 relative) through 32 layers of random weights, and
    # round in different places (the einsum decode casts its softmax weights
    # to bf16 before P.V; the kernels keep them in float32); on an H100 the
    # two differ by 1.5e-2 to 2.1e-2 of the scale. A fault in what the
    # kernels read (wrong rows, positions, masks or decays) moves logits by
    # O(1) of their scale, and phase 3 holds each kernel to its plain
    # version elementwise.
    models = {impl: build_model(cfg, attn_impl=impl) for impl in ("kernel", "einsum")}
    batch = {"tokens": tokens}
    if cfg.family not in ("ssm", "hybrid"):
        check_gap(kernel_vs_plain(params, batch, models["kernel"]), cfg.name)
        return
    if cfg.family == "hybrid":
        # Zamba2 is chaotic end to end (LayerwiseGap): each layer of the
        # kernel path is held to the plain path on the same inputs, in
        # bf16 and in float32; the end-to-end difference is printed
        for c, p in ((cfg, params), (cfg.replace(dtype="float32"), None)):
            p = p if p is not None else draw_weights(build_model(c))
            forced = LayerwiseGap(plain_impl)
            n0 = gla_scan.launches
            logit_gap(p, batch, forced.wrap(build_model(c, attn_impl="kernel")),
                      build_model(c, attn_impl="einsum"), "kernel", "einsum")
            forced.check(f"{c.dtype}: kernel vs einsum (end to end above, not "
                         "held)", 5e-2)
            print(f"{c.dtype} check: {gla_scan.launches - n0} gla_scan launches "
                  "(a check, not a served path)")
            del p
        return
    # The GLA-scan models (RWKV6, Zamba2): in bf16 RWKV6's two paths
    # differed by up to 5.2e-2 of the scale at full width on an H100, above
    # the 5e-2 Llama is held to, and two plain paths that differ only in
    # rounding (chunks of 16 and 32 tokens) by up to 5.7e-2: 24 layers of
    # random weights amplify one bf16 rounding step that far (PERF.md). In
    # float32 the kernel and plain paths agree to 9.2e-6. So the kernel
    # path is held to the plain path at 5e-2 in float32, and in bf16 to the
    # larger of 5e-2 and twice the plain-vs-plain difference measured here.
    worst = max(logit_gap(params, batch, models["kernel"], models["einsum"],
                          "kernel", "einsum"))
    floor = max(logit_gap(params, batch, chunked(models["einsum"], 16),
                          models["einsum"], "einsum chunk 16", "einsum chunk 32"))
    print(f"bf16: kernel vs einsum worst {worst:.3e}; plain vs plain (chunk "
          f"16 vs 32) worst {floor:.3e}; tol max(5e-2, 2 x plain vs plain)")
    if not worst <= max(5e-2, 2 * floor):
        fail(f"bf16 kernel and einsum logits differ by {worst:.3e} of their "
             f"scale, plain paths by {floor:.3e}")
    del models
    cfg32 = cfg.replace(dtype="float32")
    params32 = draw_weights(build_model(cfg32))
    n0 = gla_scan.launches
    worst32 = max(logit_gap(params32, batch, build_model(cfg32, attn_impl="kernel"),
                            build_model(cfg32, attn_impl="einsum"), "kernel", "einsum"))
    print(f"float32: kernel vs einsum worst relative logit difference "
          f"{worst32:.3e} (tol 5e-2); {gla_scan.launches - n0} gla_scan "
          "launches (a check, not a served path)")
    if not worst32 <= 5e-2:
        fail(f"float32 kernel and einsum logits differ by {worst32:.3e} of their scale")
    del params32


class Patched:
    """``model`` whose prefill and decode steps run with module functions
    replaced: ``patches`` maps (module, name) to a function that takes the
    original and returns its replacement. The model code itself is
    untouched; the originals come back after each call."""

    def __init__(self, model, patches: dict):
        self.model, self.patches = model, patches

    def _call(self, fn, *args):
        orig = {key: getattr(*key) for key in self.patches}
        try:
            for (module, name), make in self.patches.items():
                setattr(module, name, make(orig[module, name]))
            return fn(*args)
        finally:
            for (module, name), f in orig.items():
                setattr(module, name, f)

    def prefill(self, *args):
        return self._call(self.model.prefill, *args)

    def decode_step(self, *args):
        return self._call(self.model.decode_step, *args)


def chunked(model, chunk: int) -> Patched:
    """``model`` whose plain chunked scan (``gla_chunked``, in RWKV6's and
    Mamba2's layers) uses ``chunk`` tokens per chunk instead of its
    default: a second plain path that differs from the first only in
    rounding."""
    import functools
    from repro_torch.models import linear_attention, mamba, rwkv
    scan = lambda _: functools.partial(linear_attention.gla_chunked, chunk=chunk)
    return Patched(model, {(rwkv, "gla_chunked"): scan,
                           (mamba, "gla_chunked"): scan})


class LayerwiseGap:
    """A second computation beside every Zamba2 layer call (each Mamba2
    block, each shared-block application) on the same inputs:
    ``alt(orig, x, args, kwargs)``, held per layer as max|alt - own| /
    max|own| over the rows ``alt`` returns; the model goes on with its own
    output. The reference's Mamba2 layers have no residual, and a relative
    perturbation grows ~1.7x a layer at full width (1e-3 -> 1.0 over 12
    layers, float32, depth-cut on the CPU), so two paths that round apart
    differ by O(1) at the logits after 38 layers; per layer a fault in the
    kernels, masks or rows still moves outputs by O(1) of their scale."""

    def __init__(self, alt):
        self.alt, self.worst, self.calls = alt, 0.0, 0

    def _hook(self, orig):
        def wrapped(x, *args, **kwargs):
            out = orig(x, *args, **kwargs)
            alt = self.alt(orig, x, args, kwargs)[0].float()
            own = out[0][:alt.shape[0]].float()
            gap = float((alt - own).abs().max() / own.abs().max())
            if not gap <= self.worst:       # NaN sticks
                self.worst = gap
            self.calls += 1
            return out
        return wrapped

    def wrap(self, model) -> Patched:
        from repro_torch.models import zamba
        return Patched(model, {(zamba, "mamba_block"): self._hook,
                               (zamba, "_shared_apply"): self._hook})

    def check(self, what: str, tol: float):
        print(f"{what}: worst per-layer max|diff| / max|own| {self.worst:.3e} "
              f"over {self.calls} layer calls (tol {tol:.0e})")
        if not self.worst <= tol:
            fail(f"{what}: a layer's outputs differ by {self.worst:.3e} of "
                 "their scale")


def plain_impl(orig, x, args, kwargs):
    """The same layer on the same inputs through the plain path."""
    return orig(x, *args, **{**kwargs, "impl": "einsum"})


def one_row(orig, x, args, kwargs):
    """The same layer on row 0 alone: its input, states and a copy of its
    K/V rows (decode writes the new K/V in place)."""
    kw = dict(kwargs)
    if kw.get("conv_state") is not None:
        kw["conv_state"] = tuple(t[0:1] for t in kw["conv_state"])
    for key in ("ssm_state", "lengths", "rope"):
        if kw.get(key) is not None and kw[key].shape[0] > 1:
            kw[key] = kw[key][0:1]
    if kw.get("cache_kv") is not None:
        kw["cache_kv"] = tuple(t[0:1].clone() for t in kw["cache_kv"])
    return orig(x[0:1], *args, **kw)


class SharedRoutes:
    """The experts a model's MoE layers pick, recorded in call order by one
    model (``recorder``) and replayed to another (``replayer``), whose gates
    come from its own router probabilities at those experts. Counts the
    (token, layer) choices where the replaying model's own pick differed."""

    def __init__(self):
        self.queue, self.flips, self.total = [], 0, 0

    def recorder(self, model) -> Patched:
        from repro_torch.models import moe
        return Patched(model, {(moe, "route"): lambda f: self.route(f, True)})

    def replayer(self, model) -> Patched:
        from repro_torch.models import moe
        return Patched(model, {(moe, "route"): lambda f: self.route(f, False)})

    def route(self, orig, record: bool):
        def hooked(x, p, cfg):
            probs, gates, idx = orig(x, p, cfg)
            if record:
                self.queue.append(idx)
                return probs, gates, idx
            want = self.queue.pop(0)
            self.flips += int((want.sort(-1)[0] != idx.sort(-1)[0]).any(-1).sum())
            self.total += idx[..., 0].numel()
            g = probs.gather(-1, want)
            return probs, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want
        return hooked


def kernel_vs_plain(params, batch, model, steps: int = 5) -> float:
    """Worst relative logit difference of ``model`` (the kernel path)
    against the plain einsum path over one prefill and ``steps - 1`` decode
    steps. A MoE layer's choice of experts is discrete: where the two paths'
    router logits round a near-tie apart, a token takes other experts and
    its output moves by O(1) of an expert's share (Qwen3-MoE's two paths
    differed by 6.0e-2 of the scale on an H100, one step's argmax
    flipped). So for MoE the plain path takes the kernel path's experts
    (``SharedRoutes``) and the flips are counted and printed; the unrouted
    difference is printed, not held."""
    from repro_torch.models import build_model
    plain = build_model(model.cfg, attn_impl="einsum")
    if model.cfg.family != "moe":
        return max(logit_gap(params, batch, model, plain, "kernel", "einsum",
                             steps))
    free = max(logit_gap(params, batch, model, plain, "kernel", "einsum", steps))
    routes = SharedRoutes()
    worst = max(logit_gap(params, batch, routes.recorder(model),
                          routes.replayer(plain), "kernel",
                          "einsum routed as kernel", steps))
    print(f"routing: {routes.flips} of {routes.total} (token, layer) expert "
          f"choices of the plain path differ from the kernel path's; "
          f"unrouted worst {free:.3e} (not held)")
    return worst


def logit_gap(params, batch, a, b, name_a: str, name_b: str, steps: int = 5):
    """max|logits_a - logits_b| / max|logits_b| over one prefill of
    ``batch`` and ``steps - 1`` decode steps, both models fed ``a``'s greedy
    tokens."""
    sa = a.prefill(params, batch, 4096)
    sb = b.prefill(params, batch, 4096)
    rels = []
    for step in range(steps):
        la, lb = sa[0].float(), sb[0].float()
        if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
            fail(f"{name_a} or {name_b} logits are not finite")
        if not lb.abs().max() > 0:
            fail(f"{name_b} logits are all zero")
        rels.append(float((la - lb).abs().max() / lb.abs().max()))
        print(f"step {step}: max|{name_a} - {name_b}| / max|{name_b}| = "
              f"{rels[-1]:.3e}; argmax {int(la.argmax())} vs {int(lb.argmax())}")
        if step == steps - 1:
            break
        nxt = torch.argmax(sa[0], -1)[:, None]
        sa = a.decode_step(params, {"tokens": nxt}, sa[1])
        sb = b.decode_step(params, {"tokens": nxt}, sb[1])
    return rels


def phase_profile(model, params, phase: int, kernel_group: str,
                  kernel_names: tuple):
    """Device busy share and kernel time by name for one prefill and a few
    decode iterations: wall time from an untraced pass, device time from a
    traced pass of the same work. Kernels whose names contain one of
    ``kernel_names`` form the group ``kernel_group``."""
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    cfg = model.cfg
    print(f"== phase {phase}: where the time goes in {cfg.name} "
          "(torch.profiler): one prefill of 1024 tokens; 4 decode iterations "
          "over 8 active slots")
    engine = ServingEngine(model, params, max_slots=8, max_len=4096,
                           device="cuda")
    rng = np.random.default_rng(2)
    for i in range(8):
        engine.submit(ServeRequest(rid=i, prompt=rng.integers(1, cfg.vocab_size, 1024),
                                   max_new_tokens=64))
    for _ in range(8):
        engine.step()                         # fill the slots: 8 prefills
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, 1024), device="cuda")[None]
    profile_work("prefill", lambda: int(torch.argmax(model.prefill(
        params, {"tokens": prompt}, 4096, cache=engine.cache, slot=0)[0])),
        kernel_group, kernel_names)
    profile_work("decode", lambda: [engine.step() for _ in range(4)],
                 kernel_group, kernel_names)


def profile_work(name: str, fn, kernel_group: str, kernel_names: tuple):
    """Wall time of ``fn()`` from an untraced pass, device busy time and
    kernel time by name from a whole trace of the same work (``profiled``);
    returns (device ms by kernel name, wall ms), or None when no trace was
    whole."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    traced = profiled(fn, name)
    if traced is None:
        return None
    kernels = traced[0]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    groups = {kernel_group: 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for kname, ms in by_name.items():
        low = kname.lower()
        if any(n in low for n in kernel_names):
            groups[kernel_group] += ms
        elif any(t in low for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    print(f"{name}: wall {wall_ms:.2f} ms untraced; device busy {busy:.2f} ms "
          f"traced ({busy / wall_ms:.1%} of wall, idle {1 - busy / wall_ms:.1%}); "
          f"{len(kernels)} kernel launches")
    print("  by group: " + "; ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                                     for k, v in groups.items()))
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:8.3f} ms  {kname[:90]}")
    return by_name, wall_ms


# ---------------------------------------------------------------------------
# phase 11: the paper's simulated pipeline
# ---------------------------------------------------------------------------

def timed(fn):
    """(fn(), wall seconds of a second, warm call), the card drained
    before the clock stops: the first call also loads the CUDA modules of
    the operations it meets."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def device_ops(fn, kernel: str, launches: int) -> tuple:
    """(device operations, their summed device ms, traced wall ms) of one
    call of ``fn``, from a whole ``torch.profiler`` trace of it
    (``profiled``: kernels and copies) that holds ``launches`` kernels whose
    name holds ``kernel``."""
    traced = profiled(fn, f"{launches} {kernel} launches", lambda device: sum(
        kernel in e.name for e in device) == launches)
    if traced is None:
        fail(f"no whole profiler trace of {launches} {kernel} launches")
    ops, wall = traced
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3, wall


def close(got, want, rtol: float, what: str, atol: float = 0.0):
    """Fail unless |got - want| <= atol + rtol |want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{what}: shape {got.shape} against {want.shape}, or not finite")
    err = np.abs(got - want)
    if bool((err > atol + rtol * np.abs(want)).any()):
        fail(f"{what}: card and CPU differ by {float(err.max()):.3e}")
    return float(err.max(initial=0.0))


def table2_cosim(res, torch_device):
    """Table 2's co-sim recipe, as the reference's
    ``sweep/runner.py::_post_microgrid_cosim`` runs it at its defaults."""
    from repro_torch import core
    from repro_torch.core import datasets
    pm = core.PowerModel(res.cfg.device, torch_device=torch_device)
    load = core.stages_to_load_signal(
        res.stages.start_s, res.stages.dur_s, res.stages.mfu, pm,
        n_devices=res.cfg.n_devices, pue=1.2, resolution_s=60.0)
    n_bins, start = int(30 * 3600 / 60), int(8 * 3600 / 60)
    vals = np.full(n_bins, pm.dev.p_idle * res.cfg.n_devices * 1.2)
    n = min(len(load.values), n_bins - start)
    vals[start:start + n] = load.values[:n]
    grid = core.MicrogridConfig(battery=core.BatteryConfig(
        capacity_wh=100.0, soc_init=0.5, soc_min=0.2, soc_max=0.8))
    return core.run_cosim(
        core.Signal(np.arange(n_bins) * 60.0, vals, interp="previous"),
        datasets.solar_signal(30.0, capacity_w=600.0, seed=3, cloudiness=0.12),
        datasets.carbon_intensity_signal(30.0, seed=4), grid,
        torch_device=torch_device)


def two_site_fleet():
    """``tests/test_fleet.py``'s two-region fleet (Llama-3-8B, 48 requests
    at 5 QPS, batch cap 16), carbon-greedy routing, and the Table 1b
    microgrid (600 W solar, 100 Wh battery) at the hydro site."""
    from repro_torch import fleet, sim
    from repro_torch.configs.paper_models import LLAMA3_8B
    sites = tuple(fleet.SiteConfig(
        name=f"s{i}-{t}", device="a100", ci_trace=t,
        scheduler=sim.SchedulerConfig(batch_cap=16),
        solar_capacity_w=600.0 if i == 0 else 0.0,
        battery_capacity_wh=100.0 if i == 0 else 0.0)
        for i, t in enumerate(("hydro", "coal")))
    return fleet.FleetConfig(model=LLAMA3_8B, sites=sites,
                             workload=sim.WorkloadConfig(
                                 n_requests=48, qps=5.0, min_len=64,
                                 max_len=512, seed=0),
                             router="carbon_greedy")


def phase_simulated():
    import dataclasses

    from repro_torch import fleet, sim
    from repro_torch.core.power import DEVICE_MODE_RTOL
    from repro_torch.sim.execmodel import (TORCH_BACKEND_RTOL, StageBatch,
                                           cached_execution_model)
    print("== phase 11: the paper's simulated pipeline (Table 1a, Eqs. 1-5, "
          "Table 2, a two-site fleet), card against CPU")
    reset_counts()
    cfg = sim.PAPER_DEFAULT
    res, t_sim = timed(lambda: sim.run_simulation(cfg))
    stages = res.stages
    done = sum(1 for r in res.requests if r.t_done >= 0)
    if not (len(stages) and done == cfg.workload.n_requests
            and np.isfinite(stages.dur_s).all()):
        fail(f"run_simulation: {len(stages)} stages, {done} requests done")
    print(f"run_simulation(PAPER_DEFAULT): {cfg.model.name} on {cfg.device}, "
          f"{done} requests at {cfg.workload.qps} QPS, {len(stages)} stages "
          f"over {stages.total_duration():.3f} simulated s, host {t_sim:.3f} s")

    times = {}
    reports = {}
    for dev in ("cuda", "cpu"):
        reports[dev], times[f"energy_{dev}"] = timed(
            lambda: sim.energy_report(res, sim.PAPER_PUE, torch_device=dev))
    want = dataclasses.asdict(reports["cpu"])
    for k, v in dataclasses.asdict(reports["cuda"]).items():
        close(v, want[k], DEVICE_MODE_RTOL, f"energy_report {k}")
    print(f"energy_report (Eqs. 1-3, PUE {sim.PAPER_PUE}): energy_wh="
          f"{reports['cuda'].energy_wh!r} avg_power_w="
          f"{reports['cuda'].avg_power_w!r} avg_mfu={reports['cuda'].avg_mfu!r}"
          f" (CPU: {want['energy_wh']!r}, {want['avg_power_w']!r})")

    cosim = {}
    for dev in ("cuda", "cpu"):
        cosim[dev], times[f"table2_{dev}"] = timed(lambda: table2_cosim(res, dev))
    for k, v in cosim["cpu"].traces.items():
        close(cosim["cuda"].traces[k], v, 0.0, f"microgrid trace {k}",
              atol=1e-5 * float(np.abs(v).max(initial=0.0)))
    for k, v in cosim["cpu"].metrics.items():
        close(cosim["cuda"].metrics[k], v, DEVICE_MODE_RTOL, f"Table 2 {k}")
    steps = len(cosim["cuda"].load.times)
    from repro_torch.kernels.microgrid_scan import microgrid_scan
    n0 = microgrid_scan.launches
    ops, busy_ms, wall_ms = device_ops(lambda: table2_cosim(res, "cuda"),
                                       "microgrid_scan", 1)
    if microgrid_scan.launches - n0 != 1:
        fail(f"Table 2 co-sim: {microgrid_scan.launches - n0} microgrid_scan "
             "launches, expected 1")
    m = cosim["cuda"].metrics
    print("Table 2 co-sim (30 h at 60 s, 600 W solar, 100 Wh battery): "
          + " ".join(f"{k}={float(m[k])!r}" for k in (
              "carbon_offset_pct", "renewable_share_pct", "net_emissions_kg",
              "total_energy_kwh", "grid_dependency_pct")))
    print(f"microgrid scan on the card: {steps} steps in 1 microgrid_scan "
          f"launch (1 in the trace); {ops} device operations in the "
          f"co-sim call (the earlier "
          f"eager step loop: 46,939), device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.1f} ms traced wall (idle {1 - busy_ms / wall_ms:.1%}); "
          f"untraced wall {times['table2_cuda']:.4f} s (the earlier eager "
          f"step loop: 0.7065 s), CPU {times['table2_cpu']:.4f} s")

    fleets = {}
    for dev in ("cuda", "cpu"):
        fleets[dev], times[f"fleet_{dev}"] = timed(
            lambda: fleet.run_fleet_simulation(two_site_fleet(), torch_device=dev))
    if not np.array_equal(fleets["cuda"].assignments, fleets["cpu"].assignments):
        fail("fleet: site assignments differ between card and CPU runs")
    want = fleets["cpu"].summary()
    got = fleets["cuda"].summary()
    for k, v in want.items():
        close(got[k], v, DEVICE_MODE_RTOL, f"fleet {k}",
              atol=DEVICE_MODE_RTOL * 100.0 if k.endswith("_pct") else 0.0)
    if got["n_requests_done"] != 48:
        fail(f"fleet served {got['n_requests_done']} of 48 requests")
    print(f"two-site fleet (carbon_greedy, hydro with solar + battery, coal): "
          f"energy_wh={got['energy_wh']!r} carbon_total_g="
          f"{got['carbon_total_g']!r} carbon_offset_pct="
          f"{got['carbon_offset_pct']!r} requests per site "
          f"{[len(s.requests) for s in fleets['cuda'].sites]}")

    em = cached_execution_model(cfg.model, cfg.device, cfg.tp, cfg.pp,
                                cfg.execmodel)
    batch = StageBatch.from_trace(stages)
    plain = em.stage_cost_batch(batch)
    if not np.array_equal(plain.t_total, stages.dur_s):
        fail("roofline: the batched numpy path differs from the event loop's")
    on_card, times["roofline_cuda"] = timed(
        lambda: em.stage_cost_batch(batch, backend="torch", torch_device="cuda"))
    worst = max(close(getattr(on_card, f.name), getattr(plain, f.name),
                      TORCH_BACKEND_RTOL, f"roofline {f.name}")
                for f in dataclasses.fields(plain))
    print(f"roofline backend=torch on the card over {len(batch)} stages: max "
          f"|diff| {worst:.3e} against numpy")

    launched = {k: fn.launches for k, fn in kernel_wrappers().items()}
    others = {k: n for k, n in launched.items() if k != "microgrid_scan"}
    if any(others.values()) or not launched["microgrid_scan"]:
        fail(f"the simulated path's launches: {launched}; expected "
             "microgrid_scan only")
    print("wall s, card vs CPU: " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(times.items())))
    print(f"kernel launches in phase 11: {launched} (microgrid_scan only)")


# ---------------------------------------------------------------------------
# phase 12: the sweep engine
# ---------------------------------------------------------------------------

# the smoke sweeps that phase 12 runs in device mode too
DEVICE_MODE_SWEEPS = ("fig1", "fig3", "fig4", "exp5", "perf")


def check_sweep(name: str, mode: str, card: list, cpu: list) -> dict:
    """Classify the card's records against the CPU's with the port's
    ``obs.diff`` and fail unless every column the host computes is
    bitwise equal and every other column (Eq. 1, energy, carbon and the
    co-sim, and in device mode the program's float64 reductions of
    duration and GPU hours) lies within ``DEVICE_MODE_RTOL``; returns the
    cells' counts by contract."""
    from repro_torch.core.power import DEVICE_MODE_RTOL
    from repro_torch.obs.diff import column_phase, diff_records
    res = diff_records(cpu, card, label_a="cpu", label_b="cuda")
    if res.only_a or res.only_b or len(card) != len(cpu):
        fail(f"sweep {name} ({mode}): records do not align between card "
             f"and CPU: {len(res.only_a)} only on the CPU, "
             f"{len(res.only_b)} only on the card")
    for c in res.cells:
        on_device = (column_phase(c.column) in ("power", "energy", "carbon")
                     or (mode == "device"
                         and c.column in ("duration_s", "gpu_hours")))
        if c.contract == "regression" or c.rel > DEVICE_MODE_RTOL \
                or not on_device:
            fail(f"sweep {name} ({mode}), card against CPU: {c.format()}")
    counts = res.by_contract()
    counts["host-bitwise"] = res.n_compared - len(res.cells)
    return counts


def phase_sweeps() -> int:
    """The port's sweep engine: all twelve smoke sweeps through
    ``run_sweep`` (vectorized mode), and the device-mode ones again in
    device mode, on the card and on the CPU in this process, card held
    against CPU. Returns microgrid_scan's launches in the card's runs."""
    from repro_torch.sweep.scenarios import SWEEPS, run_sweep
    print("== phase 12: the sweep engine, all smoke sweeps (vectorized; "
          f"device mode for {', '.join(DEVICE_MODE_SWEEPS)}), card against "
          "CPU (host columns bitwise, Eq. 1 and co-sim columns within "
          "DEVICE_MODE_RTOL)")
    for dev in ("cuda", "cpu"):      # load each device's modules untimed
        run_sweep("fig1", smoke=True, torch_device=dev)
    reset_counts()
    launches = dict.fromkeys(kernel_wrappers(), 0)
    runs = [(name, "vectorized") for name in SWEEPS]
    runs += [(name, "device") for name in DEVICE_MODE_SWEEPS]
    for name, mode in runs:
        out, wall = {}, {}
        for dev in ("cuda", "cpu"):
            before = {k: fn.launches for k, fn in kernel_wrappers().items()}
            t = time.perf_counter()
            out[dev] = run_sweep(name, smoke=True, mode=mode,
                                 torch_device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall[dev] = time.perf_counter() - t
            for k, fn in kernel_wrappers().items():
                if dev == "cuda":
                    launches[k] += fn.launches - before[k]
                elif fn.launches != before[k]:
                    fail(f"sweep {name} on the CPU launched {k}")
        records, stats, derived = out["cuda"]
        counts = check_sweep(name, mode, records, out["cpu"][0])
        if name == "day" and not all(
                "plans_match=True" in d and "exact_bitwise=True" in d
                for d in (derived, out["cpu"][2])):
            fail(f"day: hybrid and event_loop disagree: card {derived!r}, "
                 f"CPU {out['cpu'][2]!r}")
        if derived != out["cpu"][2]:
            print(f"  note: {name} derived lines differ: card {derived!r} "
                  f"CPU {out['cpu'][2]!r}")
        print(f"sweep {name} {mode}: {len(records)} scenarios, "
              f"{stats.trace_groups} trace groups; wall card "
              f"{wall['cuda']:.4f} s, CPU {wall['cpu']:.4f} s; cells by "
              f"contract {counts}; derived: {derived}")
    others = {k: n for k, n in launches.items() if k != "microgrid_scan"}
    print(f"kernel launches in phase 12 (card runs): {launches}")
    if any(others.values()) or not launches["microgrid_scan"]:
        fail(f"the sweep engine's launches: {launches}; expected "
             "microgrid_scan only")
    return launches["microgrid_scan"]


# ---------------------------------------------------------------------------
# phase 18: the physics-invariant auditor and the remote sweep backend
# ---------------------------------------------------------------------------

# tests/test_audit.py's smoke sweeps and request counts
AUDIT_SWEEPS = (("fig1", 16), ("fleet", 10), ("shift", 10))
# the full sweeps that card workers compute, and the mode of each
REMOTE_SWEEPS = (("carbon", "vectorized"), ("perf", "device"))


def same_records(got: list, want: list, what: str):
    """Fail unless the records carry the same keys and bit-identical
    metrics (``remote.same_metrics``: NaN equals NaN)."""
    from repro_torch.sweep.remote import same_metrics
    if [r["key"] for r in got] != [r["key"] for r in want]:
        fail(f"{what}: the records' keys differ")
    for a, b in zip(got, want):
        if not same_metrics(a["metrics"], b["metrics"]):
            fail(f"{what}: metrics of {a['scenario']} differ: "
                 f"{a['metrics']} against {b['metrics']}")


def audit_day_config():
    """tests/test_audit.py's day config: 1200 requests over 900 s on one
    site (caiso-night), hybrid day mode with 300 s epochs."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.fleet.config import FleetConfig, SiteConfig
    from repro_torch.sim.hybrid import DayConfig
    from repro_torch.sim.requests import WorkloadConfig
    from repro_torch.sim.scheduler import SchedulerConfig
    n, span = 1200, 900.0
    wl = WorkloadConfig(
        n_requests=n, qps=n / span, min_len=192, max_len=192, seed=0,
        envelope="sinusoidal", envelope_amplitude=0.3,
        envelope_period_h=span / 3600.0, burst_gain=2.5,
        burst_mean_s=span / 15.0, burst_idle_mean_s=span / 2.5)
    return FleetConfig(
        model=LLAMA3_8B,
        sites=(SiteConfig(name="s0", ci_trace="caiso-night",
                          scheduler=SchedulerConfig(batch_cap=64)),),
        workload=wl, router="round_robin",
        day=DayConfig(mode="hybrid", epoch_s=300.0, pilot_requests=128,
                      warmup_requests=32, util_threshold=0.6))


def phase_audit():
    """18a: the auditor on the card, held against the same runs on the
    CPU, the day simulation, and the CLI's ``--audit``."""
    from repro_torch.fleet.day import run_fleet_day
    from repro_torch.obs.audit import AuditProbe
    from repro_torch.sweep.runner import SweepRunner
    from repro_torch.sweep.scenarios import SWEEPS
    for name, n_req in AUDIT_SWEEPS:
        scenarios = SWEEPS[name].build(True, n_requests=n_req)
        reports, wall = {}, {}
        for dev in ("cuda", "cpu"):
            off = SweepRunner(mode="event_loop", torch_device=dev).run(
                scenarios)[0]
            auditor = AuditProbe()
            t = time.perf_counter()
            on = SweepRunner(mode="event_loop", probe=auditor,
                             torch_device=dev).run(scenarios)[0]
            wall[dev] = time.perf_counter() - t
            same_records(on, off, f"audit {name} on {dev}: the records "
                         "with the auditor against those without")
            reports[dev] = rep = auditor.report()
            if not rep.ok:
                fail(f"audit {name} on {dev}: {rep.summary()}")
        card, cpu = reports["cuda"], reports["cpu"]
        if (card.runs, card.checks) != (cpu.runs, cpu.checks) \
                or card.runs != len(scenarios):
            fail(f"audit {name}: card runs {card.runs} checks {card.checks}; "
                 f"CPU runs {cpu.runs} checks {cpu.checks}")
        if name == "shift" and not card.checks.get("eq45-closure"):
            fail(f"audit shift: eq45-closure not armed: {card.checks}")
        print(f"audit {name}: {len(scenarios)} scenarios, {card.runs} runs, "
              f"card = CPU checks {card.checks}; wall with the auditor card "
              f"{wall['cuda']:.4f} s, CPU {wall['cpu']:.4f} s; "
              f"{card.summary()}")

    cfg = audit_day_config()
    auditor = AuditProbe()
    off = run_fleet_day(cfg, torch_device="cuda").summary()
    t = time.perf_counter()
    on = run_fleet_day(cfg, probe=auditor, torch_device="cuda").summary()
    wall = time.perf_counter() - t
    from repro_torch.sweep.remote import same_metrics
    if not same_metrics(on, off):
        fail("audit day: the summary with the auditor differs from the one "
             "without")
    rep = auditor.report()
    if not rep.ok or not rep.checks.get("clock-monotonic") \
            or not rep.checks.get("eq45-closure"):
        fail(f"audit day: {rep.summary()}; checks {rep.checks}")
    print(f"audit day (1200 requests, hybrid): checks {rep.checks}; wall "
          f"with the auditor {wall:.4f} s; {rep.summary()}")

    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "REPRO_TORCH_SWEEP_CACHE": str(Path(tmp) / "cache")}
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.sweep.cli", "fig1",
             "--smoke", "--audit", "--torch-device", "cuda"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t
    audit_lines = [ln.strip() for ln in out.stdout.splitlines()
                   if ln.strip().startswith("audit:")]
    if out.returncode != 0 or not audit_lines \
            or not audit_lines[0].startswith("audit: clean"):
        fail(f"sweep.cli fig1 --smoke --audit on the card: exit "
             f"{out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    print(f"sweep.cli fig1 --smoke --audit --torch-device cuda: exit 0 in "
          f"{wall:.2f} s; {audit_lines[0]}")


def stop_workers(queue: Path, procs: list, logs: list):
    """Stop workers through the queue's stop file; fail unless each exits
    with 0 (its log's tail printed)."""
    (queue / "stop").touch()
    for proc, log in zip(procs, logs):
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"worker {log.name} did not stop")
        if code != 0:
            fail(f"worker {log.name} exited with {code}:\n"
                 f"{log.read_text()[-3000:]}")


def worker_manifests(jobs) -> list:
    return [json.loads(m.read_text()) for job in sorted(jobs)
            for m in sorted((job / "done").glob("shard-*.json"))]


def phase_remote(tmp: Path) -> int:
    """18b: two card workers compute the full carbon and perf sweeps;
    returns microgrid_scan's launches in the in-process carbon run."""
    from repro_torch.sweep import ResultCache, SweepRunner
    from repro_torch.sweep.remote import (RemoteOptions, spawn_worker,
                                          wait_for_workers)
    from repro_torch.sweep.scenarios import SWEEPS
    queue = tmp / "q"
    logs = [tmp / f"w{i}.log" for i in range(2)]
    t = time.perf_counter()
    procs = [spawn_worker(queue, f"w{i}", torch_device="cuda", log_path=log)
             for i, log in enumerate(logs)]
    launches = 0
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                wait_for_workers(queue, 2, timeout_s=1.0)
                break
            except TimeoutError:
                dead = [log for proc, log in zip(procs, logs)
                        if proc.poll() is not None]
                if dead or time.monotonic() > deadline:
                    fail("card workers did not register: " + "\n".join(
                        f"{log.name}: {log.read_text()[-3000:]}"
                        for log in (dead or logs)))
        warm_wall = time.perf_counter() - t
        warm = [json.loads(a.read_text())["warmup_s"]
                for a in sorted((queue / "workers").glob("*.alive"))]
        print(f"remote: 2 card workers registered in {warm_wall:.2f} s "
              f"(their own warm-up: {', '.join(f'{w:.2f} s' for w in warm)})")
        opts = RemoteOptions(queue_dir=queue, spawn_workers=0, lease_s=60.0,
                             verify_groups=1, timeout_s=240)
        for name, mode in REMOTE_SWEEPS:
            scenarios = SWEEPS[name].build(False)
            jobs0 = set(queue.glob("job-*"))
            t = time.perf_counter()
            records, stats = SweepRunner(
                cache=ResultCache(tmp / "cache", torch_device="cuda"),
                backend="remote", remote=opts, mode=mode,
                torch_device="cuda").run(scenarios)
            wall = time.perf_counter() - t
            manifests = worker_manifests(set(queue.glob("job-*")) - jobs0)
            reset_counts()
            t = time.perf_counter()
            local = SweepRunner(mode=mode, torch_device="cuda").run(
                scenarios)[0]
            torch.cuda.synchronize()
            local_wall = time.perf_counter() - t
            counts = {k: fn.launches for k, fn in kernel_wrappers().items()}
            same_records(records, local, f"remote {name} ({mode}) against "
                         "the in-process card run")
            t = time.perf_counter()
            again, stats2 = SweepRunner(
                cache=ResultCache(tmp / "cache", torch_device="cuda"),
                backend="remote", remote=opts, mode=mode,
                torch_device="cuda").run(scenarios)
            again_wall = time.perf_counter() - t
            same_records(again, local, f"remote {name} ({mode}) from the "
                         "cache against the in-process card run")
            in_workers = sum(m["microgrid_scan_launches"] for m in manifests)
            expect_workers = min(2, stats.shards)
            if (stats.executed != len(scenarios) or stats2.executed
                    or stats2.cache_hits != len(scenarios)
                    or stats.lease_expired or stats.quarantined
                    or stats.remote_workers != expect_workers
                    or len(manifests) != stats.shards
                    or any(m["torch_device"] != "cuda" for m in manifests)):
                fail(f"remote {name} ({mode}): {stats.summary()}; again "
                     f"{stats2.summary()}; {len(manifests)} manifests")
            others = {k: n for k, n in counts.items() if k != "microgrid_scan"}
            if any(others.values()) or (name == "carbon" and not (
                    counts["microgrid_scan"] and in_workers)):
                fail(f"remote {name}: launches in process {counts}, "
                     f"microgrid_scan in the workers {in_workers}")
            if name == "carbon":
                launches = counts["microgrid_scan"]
            print(f"remote {name} {mode}: {len(scenarios)} scenarios, "
                  f"{stats.trace_groups} trace groups in {stats.shards} "
                  f"shards on {stats.remote_workers} card workers (the "
                  f"shards allow {expect_workers}); wall remote "
                  f"{wall:.4f} s (one group re-run in process to verify), "
                  f"in process {local_wall:.4f} s, remote again "
                  f"{again_wall:.4f} s ({stats2.cache_hits} cache hits); "
                  f"expired {stats.lease_expired}, retried {stats.retried}, "
                  f"quarantined {stats.quarantined}; microgrid_scan "
                  f"launches in process {counts['microgrid_scan']}, in the "
                  f"workers {in_workers}; records bit-identical")
    finally:
        stop_workers(queue, procs, logs)
    return launches


def tiny_grid():
    """tests/test_remote.py's tiny grid: four trace groups (QPS) of three
    PUE points, 10 requests each."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.sim import SchedulerConfig, SimConfig, WorkloadConfig
    from repro_torch.sweep import GridSpec
    base = SimConfig(model=LLAMA3_8B,
                     workload=WorkloadConfig(n_requests=10, qps=4.0,
                                             min_len=64, max_len=256, seed=0),
                     scheduler=SchedulerConfig(batch_cap=8))
    return GridSpec(base=base,
                    axes={"workload.qps": [2.0, 3.0, 4.0, 5.0],
                          "pue": [1.0, 1.1, 1.2]}).expand()


def phase_remote_crash(tmp: Path):
    """18c: a card worker killed after one group; its shard is reclaimed
    and re-run by a second card worker."""
    import threading

    from repro_torch.sweep import ResultCache, SweepRunner
    from repro_torch.sweep.remote import (ENV_CRASH_AFTER_GROUPS,
                                          RemoteOptions, spawn_worker)
    scenarios = tiny_grid()
    cache = ResultCache(tmp / "crash-cache", torch_device="cuda")
    queue = tmp / "crash-q"
    opts = RemoteOptions(queue_dir=queue, spawn_workers=0, n_shards=2,
                         lease_s=1.0, poll_s=0.05, timeout_s=180)
    out = {}

    def coordinate():
        try:
            out["res"] = SweepRunner(cache=cache, backend="remote",
                                     remote=opts, torch_device="cuda"
                                     ).run(scenarios)
        except BaseException as exc:    # reported below, never swallowed
            out["err"] = exc

    t0 = time.perf_counter()
    coordinator = threading.Thread(target=coordinate)
    coordinator.start()
    logs = [tmp / "crashy.log", tmp / "steady.log"]
    crashy = spawn_worker(queue, "crashy", torch_device="cuda",
                          env={ENV_CRASH_AFTER_GROUPS: "1"}, log_path=logs[0])
    # the steady worker starts once the crashy one holds a claim, so its
    # warm-up overlaps the crash and the lease
    deadline = time.monotonic() + 300
    while not list(queue.glob("job-*/running/*.crashy.pkl")) \
            and crashy.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    steady = spawn_worker(queue, "steady", torch_device="cuda",
                          log_path=logs[1])
    try:
        code = crashy.wait(timeout=300)
        if code != 17:
            fail(f"the crashy worker exited with {code}, not 17:\n"
                 f"{logs[0].read_text()[-3000:]}")
        coordinator.join(timeout=300)
    finally:
        stop_workers(queue, [steady], logs[1:])
        coordinator.join(timeout=60)
    if coordinator.is_alive() or "err" in out:
        fail(f"remote crash run: {out.get('err')!r}")
    records, stats = out["res"]
    wall = time.perf_counter() - t0
    local = SweepRunner(mode="vectorized", torch_device="cuda").run(
        scenarios)[0]
    same_records(records, local, "remote crash run against the in-process "
                 "card run")
    keys = sorted(cache.iter_keys())
    files = sorted(p.name for p in cache.root.rglob("*") if p.is_file())
    if keys != sorted({sc.key for sc in scenarios}) \
            or files != sorted(f"{k}.json" for k in keys) \
            or any(json.loads(cache.path_for(k).read_text())["key"] != k
                   for k in keys):
        fail(f"remote crash run: cache holds {len(files)} files for "
             f"{len(keys)} keys")
    if stats.lease_expired < 1 or stats.retried < 1 or stats.quarantined:
        fail(f"remote crash run: {stats.summary()}")
    print(f"remote crash: worker exited 17 after one group; {stats.shards} "
          f"shards, {stats.lease_expired} expired lease(s), {stats.retried} "
          f"retried, {stats.quarantined} quarantined, {len(keys)} cache "
          f"files for {len(keys)} keys; records bit-identical; wall "
          f"{wall:.2f} s")


def phase_audit_remote() -> int:
    """Phase 18; returns microgrid_scan's launches in 18b's in-process
    carbon run."""
    print("== phase 18: the physics-invariant auditor and the remote sweep "
          "backend on the card (audits card against CPU; card workers' "
          "records bit-identical to the in-process card run's)")
    t0 = time.perf_counter()
    phase_audit()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_remote_"))
    try:
        launches = phase_remote(tmp)
        phase_remote_crash(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18 wall {time.perf_counter() - t0:.1f} s")
    return launches


def draw_weights(model):
    """``model.init(0)`` on the card. For Zamba2 each Mamba2 layer's
    out_proj is then scaled by MAMBA_OUT_SCALE: the reference's Mamba2
    layers have no residual connection, and under its init scales the
    hidden state shrinks layer by layer (rms 0.88 -> 7e-15 over six layers
    at full width, then exactly 0: every logit 0, every argmax 0), which
    would leave the phase's comparisons nothing to compare. At 2x it stays
    near 1.7 through every layer."""
    params = model.init(0, device="cuda")
    if model.cfg.family == "hybrid":
        with torch.no_grad():
            for layer in params.layers:
                layer.out_proj.mul_(MAMBA_OUT_SCALE)
        print(f"{model.cfg.name}: Mamba2 out_proj drawn at {MAMBA_OUT_SCALE}x "
              "the reference's scale (no residual: the stream vanishes at 1x)")
    return params


def full_width(name: str, n_layers: int = None):
    """The model at its published widths, random weights drawn on the card
    from seed 0; ``n_layers`` cuts its depth (printed)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name)
    if n_layers is not None:
        print(f"{name}: depth cut to {n_layers} of {cfg.n_layers} layers "
              f"({cfg.param_count() / 1e9:.1f} B parameters, "
              f"{cfg.param_count() * 2 / 1e9:.0f} GB in bf16, exceed the card)")
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = draw_weights(model)
    torch.cuda.synchronize()
    print(f"full-width {name} weights: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"parameters drawn in {time.perf_counter() - t:.1f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"nvidia-smi name, power.limit: {nvidia_smi('name,power.limit')}")
    return model, params


def check_gap(worst: float, what: str, tol: float = 5e-2):
    print(f"{what}: kernel vs einsum worst relative logit difference "
          f"{worst:.3e} (tol {tol:.0e})")
    if not worst <= tol:
        fail(f"{what}: kernel and einsum logits differ by {worst:.3e} of their scale")


def phase_window(model, params):
    """Mixtral at full width (depth cut): one prompt past the 4096-token
    window through the engine, so flash's window mask and decode's ring run
    on a model; then its kernel path against the plain path over the same
    prompt and 4 decode steps past the window."""
    cfg = model.cfg
    counts = phase_engine(model, params, "14b", lens=[MIXTRAL_PROMPT],
                          new_tokens=16, max_len=8192)
    print(f"== phase 14c: {cfg.name} kernel vs einsum, a {MIXTRAL_PROMPT}-token "
          f"prompt (window {cfg.attention.sliding_window}) and 4 decode steps")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab_size, MIXTRAL_PROMPT), device="cuda")[None]
    check_gap(kernel_vs_plain(params, {"tokens": tokens}, model), cfg.name)
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def grid_positions(n_text: int, rows: int, cols: int, n_after: int):
    """M-RoPE ids (1, S, 3) as Qwen2-VL numbers an image between text:
    ``n_text`` text tokens, a rows x cols patch grid (t fixed, h and w its
    row and column), ``n_after`` text tokens after it."""
    pos = [(i, i, i) for i in range(n_text)]
    pos += [(n_text, n_text + r, n_text + c) for r in range(rows)
            for c in range(cols)]
    nxt = n_text + max(rows, cols)
    pos += [(nxt + i,) * 3 for i in range(n_after)]
    return torch.tensor(pos, dtype=torch.long, device="cuda")[None]


def phase_vlm_grid(model, params):
    """One Qwen2-VL prefill from patch embeddings with a (t, h, w) grid of
    positions whose streams differ, kernel path against plain path."""
    cfg = model.cfg
    p3 = grid_positions(64, 28, 28, 176)
    S = p3.shape[1]
    print(f"== phase 15b: {cfg.name} prefill of {S} embeddings with M-RoPE "
          "grid positions (64 text, a 28x28 patch grid, 176 text)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"embeds": torch.randn((1, S, cfg.d_model), generator=gen,
                                   device="cuda").to(torch.bfloat16),
             "positions3": p3}
    reset_counts()
    logits, _ = model.prefill(params, batch, 4096)
    torch.cuda.synchronize()
    counts = check_counts(cfg, 1)
    check_gap(kernel_vs_plain(params, batch, model, steps=1),
              f"{cfg.name} grid prefill")
    return counts


def phase_encoder(model, params):
    """HuBERT at full width: one encoder prefill of seeded frame embeddings
    at B=4, S=1024 through the non-causal flash kernel (head_dim 80, the
    wgmma route), timed, its launches counted, held against the plain path;
    then where the prefill's time goes (16a)."""
    from repro_torch.kernels.flash_attention.ops import kernel_route
    from repro_torch.launch.serve import energy_report
    from repro_torch.serve.engine import IterationLog
    cfg = model.cfg
    B, S, D = 4, 1024, cfg.attention.head_dim
    route = kernel_route(torch.bfloat16, D)[0]
    print(f"== phase 16: full-width {cfg.name} encoder prefill, B={B} S={S} "
          f"frame embeddings (non-causal, head_dim {D}, flash route {route}); "
          f"nvidia-smi name, power.limit: {nvidia_smi('name,power.limit')}")
    if route != "wgmma":
        fail(f"flash at bf16 head_dim {D} takes {route}, not the wgmma kernel")
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                   device="cuda").to(torch.bfloat16)}
    model.prefill(params, batch, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, cache = model.prefill(params, batch, S)
    torch.cuda.synchronize()
    counts = check_counts(cfg, 1)
    if cache is not None or logits.shape != (B, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"encoder prefill gave {tuple(logits.shape)} logits, cache {cache}")
    durs = []
    for _ in range(5):
        t = time.perf_counter()
        model.prefill(params, batch, S)
        torch.cuda.synchronize()
        durs.append(time.perf_counter() - t)
    med = float(np.median(durs))
    print(f"prefill {B}x{S} frames: median {med * 1e3:.2f} ms over 5 "
          f"({B * S / med:.0f} frames/s; {HUBERT_MMA_SYNC_MS[0]}-"
          f"{HUBERT_MMA_SYNC_MS[1]} ms when flash ran mma.sync at head_dim 80, "
          "H100 80GB HBM3 at 700 W); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    trace = types.SimpleNamespace(
        logs=[IterationLog(0.0, med, "prefill", B * S, B)], clock=med)
    wh, rep, prof = energy_report(trace, cfg, "h100", 400.0)
    print(f"Eq. 1/3 energy {wh * 1000:.4f} mWh, Eq. 4 carbon "
          f"{rep.total_g:.6f} gCO2 per prefill (CI=400, profile {prof.name})")
    check_gap(kernel_vs_plain(params, batch, model, steps=1), cfg.name)
    print(f"== phase 16a: where the time goes in one {cfg.name} encoder "
          f"prefill of {B}x{S} frames (torch.profiler)")
    profile_work("prefill", lambda: model.prefill(params, batch, S),
                 "flash_attention", ("flash_fwd",))
    return counts


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------

def check_train_counts(n_layers: int, steps: int, remat: bool = False) -> dict:
    """Launches since ``reset_counts``: flash's forward (with lse) and its
    backward once per layer and step (the forward twice with remat), every
    other kernel never."""
    got = {name: fn.launches for name, fn in kernel_wrappers().items()}
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = n_layers * steps * (2 if remat else 1)
    want["flash_attention_bwd"] = n_layers * steps
    print(f"launches {got}; expected {want} ({n_layers} layers x {steps} steps)")
    if got != want:
        fail(f"training launch counts {got} != expected {want}")
    return got


def grad_gap(got: dict, want: dict, what: str, tol: float = GRAD_TOL) -> float:
    """Worst relative Frobenius distance over the leaves (a leaf whose
    gradient is 0 relative to 1e-3 of the largest leaf's norm); fails above
    ``tol``."""
    floor = 1e-3 * max(float(torch.linalg.vector_norm(w.float()))
                       for w in want.values())
    gaps = {name: float(torch.linalg.vector_norm((got[name] - w).float())
                        / max(float(torch.linalg.vector_norm(w.float())), floor))
            for name, w in want.items()}
    name, worst = max(gaps.items(), key=lambda kv: kv[1])
    print(f"{what}: worst leaf gradient gap {worst:.3e} ({name}; median "
          f"{float(np.median(list(gaps.values()))):.3e}; tol {tol:.0e})")
    if not worst <= tol:
        fail(f"{what}: gradient of {name} differs by {worst:.3e}")
    return worst


def phase_train() -> dict:
    """Phase 17: smollm-360m at its published widths trained through the
    launcher: 20 steps, then a restart to 24 from the committed step 20;
    17a-c: kernel against plain gradients, gradient accumulation, where a
    step's time goes. Returns the main path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(TRAIN_ARCH)
    L, tokens = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    print(f"== phase 17: full-width {TRAIN_ARCH} training through "
          f"repro_torch.launch.train.main: {L} layers, d_model {cfg.d_model}, "
          f"GQA {cfg.attention.n_heads}/{cfg.attention.n_kv_heads}, "
          f"{cfg.param_count() / 1e6:.1f} M parameters, float32 masters, bf16 "
          f"compute; SyntheticLM seq {TRAIN_SEQ} batch {TRAIN_BATCH} seed 0; "
          f"{TRAIN_STEPS} steps, then a restart to {RESTART_STEPS}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch",
                str(TRAIN_BATCH), "--ckpt-dir", ckpt]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"before: nvidia-smi clocks.sm, power.draw: "
              f"{nvidia_smi('clocks.sm,power.draw')}")
        reset_counts()
        out = train.main(argv + ["--steps", str(TRAIN_STEPS)], device="cuda")
        torch.cuda.synchronize()
        counts = check_train_counts(L, TRAIN_STEPS)
        print(f"after: nvidia-smi clocks.sm, power.draw: "
              f"{nvidia_smi('clocks.sm,power.draw')}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = out["losses"]
        print("losses " + ", ".join(f"{x:.4f}" for x in losses))
        if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
            fail(f"{len(losses)} losses of {TRAIN_STEPS}, finite: "
                 f"{np.isfinite(losses).all()}")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"mean of the first 5 losses {first:.4f}, of the last 5 "
              f"{last:.4f}: fell {first - last:.4f} (gate >= {TRAIN_MARGIN})")
        if not first - last >= TRAIN_MARGIN:
            fail(f"the loss fell {first - last:.4f}, under {TRAIN_MARGIN}")
        step_s = float(np.median(out["step_times"][5:]))
        writes = out["runner"].manager.timings
        print(f"step {step_s * 1e3:.2f} ms (median of steps 5-{TRAIN_STEPS - 1}, "
              f"each to its float(loss)); {tokens / step_s:.0f} tokens/s; MFU "
              f"{6 * cfg.param_count() * tokens / step_s / MFU_PEAK_FLOPS:.4f} "
              f"(6 x param_count x tokens / step / {MFU_PEAK_FLOPS / 1e12:.1f} "
              f"TFLOP/s); max_memory_allocated {peak:.2f} GB")
        print("checkpoints (step, snapshot s, write s): " + "; ".join(
            f"{st}, {a:.3f}, {b:.3f}" for st, a, b in writes))
        if not peak < 80:
            fail(f"peak device memory {peak:.2f} GB")
        del out
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        again = train.main(argv + ["--steps", str(RESTART_STEPS)], device="cuda")
        torch.cuda.synchronize()
        print(f"restart: from step {again['start_step']} to "
              f"{again['final_step']}, losses "
              + ", ".join(f"{x:.4f}" for x in again["losses"]))
        if (again["start_step"], again["final_step"]) != (TRAIN_STEPS, RESTART_STEPS) \
                or not np.all(np.isfinite(again["losses"])):
            fail("the restart did not resume from the committed step "
                 f"{TRAIN_STEPS} and run to {RESTART_STEPS}")
        check_train_counts(L, RESTART_STEPS - TRAIN_STEPS)
        del again
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    phase_train_checks(cfg)
    return counts


def phase_train_checks(cfg):
    """17a: one step's gradients, kernel against plain, from the same masters
    and batch (B=1); 17b: gradient accumulation 4 against 1 on one batch of
    8; 17c: where one training step's time goes."""
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (accumulated, batch_to,
                                           make_train_step,
                                           make_value_and_grad, param_dict)
    kernel = build_model(cfg)
    params = param_dict(kernel.init(0, device="cuda", dtype=torch.float32))
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0))
    batch = batch_to(ds.batch(0), "cuda")
    one = {k: v[:1] for k, v in batch.items()}

    print(f"== phase 17a: one step's gradients at B=1 S={TRAIN_SEQ}, "
          "attention through the flash kernels against the plain einsum path, "
          f"same float32 masters and batch; loss within 1e-2 relative, each "
          f"leaf within {GRAD_TOL:.0e} relative Frobenius")
    reset_counts()
    loss_k, _, grads_k = make_value_and_grad(kernel)(params, one)
    check_train_counts(cfg.n_layers, 1)
    loss_e, _, grads_e = make_value_and_grad(
        build_model(cfg, attn_impl="einsum"))(params, one)
    # relative: the random tied embedding (entries of scale 1) starts the
    # loss near 212, where bf16's rounding moves it by ~1e-4 of itself
    gap = abs(float(loss_k) - float(loss_e)) / abs(float(loss_e))
    print(f"loss kernel {float(loss_k):.6f}, einsum {float(loss_e):.6f}: "
          f"{gap:.3e} relative")
    if not gap <= 1e-2:
        fail(f"kernel and einsum losses differ: {float(loss_k)} {float(loss_e)}")
    grad_gap(grads_k, grads_e, "kernel vs einsum")
    del grads_k, grads_e
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== phase 17b: gradient accumulation 4 against 1 on one batch of "
          f"{TRAIN_BATCH} (strided microbatches); each leaf within {GRAD_TOL:.0e}")
    vg = make_value_and_grad(kernel)
    loss1, _, full = accumulated(vg, params, batch, 1)
    loss4, _, acc = accumulated(vg, params, batch, 4)
    print(f"loss full batch {float(loss1):.6f}, mean of 4 microbatches "
          f"{float(loss4):.6f}")
    grad_gap(acc, full, "grad_accum 4 vs 1")
    del full, acc
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 17c: where one training step's time goes (torch.profiler; "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}, AdamW included)")
    step = make_train_step(kernel, AdamWConfig(lr=1e-3, warmup_steps=10,
                                               total_steps=100))
    state = adamw_init(params)
    traced = profile_work("train step", lambda: float(step(params, state, batch)[2]["loss"]),
                          "flash kernels", ("flash_fwd", "flash_bwd"))
    if traced is None:
        fail("no whole profiler trace of a training step")
    by_name, wall_ms = traced
    busy = sum(by_name.values())
    for part, key in (("forward", "flash_fwd"), ("backward", "flash_bwd")):
        ms = sum(v for n, v in by_name.items() if key in n)
        print(f"flash {part}: {ms:.2f} ms ({ms / busy:.1%} of device busy, "
              f"{ms / wall_ms:.1%} of wall)")
    del params, state, batch


def phase_train_f32() -> dict:
    """Phase 17d: smollm-360m at its published widths trained in float32
    (float32 masters and compute) through ``make_train_step``, which every
    trainer path runs (the launcher has no dtype flag, as the reference's
    has none): F32_TRAIN_STEPS steps of SyntheticLM at seq TRAIN_SEQ batch
    TRAIN_BATCH, flash's float32 forward and backward once per layer and
    step; then one profiled step and one step's gradients at B=1 through
    the kernels against the einsum path. Returns the launches of the timed
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import kernel_route
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (batch_to, make_train_step,
                                           make_value_and_grad, param_dict)
    cfg = get_config(TRAIN_ARCH).replace(dtype="float32")
    L, B, S = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ
    D = cfg.d_model // cfg.attention.n_heads
    print(f"== phase 17d: full-width {TRAIN_ARCH} in float32 (masters and "
          f"compute) through make_train_step: SyntheticLM seq {S} batch {B} "
          f"seed 0, {F32_TRAIN_STEPS} steps; flash routes forward "
          f"{kernel_route(torch.float32, D)[0]}, backward "
          f"{kernel_route(torch.float32, D, backward=True)[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = param_dict(model.init(0, device="cuda", dtype=torch.float32))
    start = params
    state = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=10,
                                              total_steps=100))
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                global_batch=B, seed=0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(F32_TRAIN_STEPS):
        batch = ds.batch(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t)
    counts = check_train_counts(L, F32_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(times[2:6]))
    print("losses " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"step {step_s * 1e3:.2f} ms (median of steps 2-5, each to its "
          f"float(loss)); {B * S / step_s:.0f} tokens/s; "
          f"max_memory_allocated {peak:.2f} GB")
    if not np.all(np.isfinite(losses)):
        fail("phase 17d: a loss is not finite")
    if not peak < 80:
        fail(f"phase 17d: peak device memory {peak:.2f} GB")
    batch = ds.batch(0)
    traced = profile_work("float32 train step",
                          lambda: float(step(params, state, batch)[2]["loss"]),
                          "flash kernels", ("flash_fwd", "flash_bwd"))
    if traced is None:
        fail("phase 17d: no whole profiler trace of a training step")
    by_name, wall_ms = traced
    busy = sum(by_name.values())
    ms = sum(v for n, v in by_name.items() if "flash_" in n)
    print(f"flash forward and backward: {ms:.2f} ms ({ms / busy:.1%} of "
          f"device busy, {ms / wall_ms:.1%} of wall)")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    one = batch_to({k: v[:1] for k, v in ds.batch(0).items()}, "cuda")
    loss_k, _, grads_k = make_value_and_grad(model)(start, one)
    loss_e, _, grads_e = make_value_and_grad(
        build_model(cfg, attn_impl="einsum"))(start, one)
    gap = abs(float(loss_k) - float(loss_e)) / abs(float(loss_e))
    print(f"one step at B=1, kernels vs einsum: loss {float(loss_k):.7f} vs "
          f"{float(loss_e):.7f}, {gap:.3e} relative (tol {F32_LOSS_TOL:.0e})")
    grad_gap(grads_k, grads_e, "float32 kernels vs einsum", tol=F32_GRAD_TOL)
    if not gap <= F32_LOSS_TOL:
        fail(f"phase 17d: kernel and einsum losses differ by {gap:.3e}")
    del grads_k, grads_e, start
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_and_check(name: str, phase: int, kernel_names: tuple, **cut):
    """Phases 13-15: the model at full width served by the engine (its
    launches counted), its consistency checks and where its time goes."""
    model, params = full_width(name, **cut)
    counts = phase_engine(model, params, f"{phase}a")
    phase_consistency(model, params, f"{phase}a")
    phase_profile(model, params, f"{phase}a", "kernels", kernel_names)
    return model, params, counts


def add_counts(total: dict, counts: dict):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def kernel_entry(name, source, replaces, launches, row) -> dict:
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, range(1, 19))),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()
    device = phase_card()
    if 2 in phases:
        phase_build()
    rows = {}
    if 3 in phases:
        rows = phase_kernels()
    if 4 in phases:
        phase_launcher()
    counts, rwkv_counts = {}, {}
    if phases & {5, 6, 7}:
        model, params = full_width(ARCH)
        if 5 in phases:
            counts = phase_engine(model, params, 5)
        if 6 in phases:
            phase_consistency(model, params, 6)
        if 7 in phases:
            phase_profile(model, params, 7, "attention kernels",
                          ("flash_fwd", "decode_mma", "decode_split",
                           "decode_combine"))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if phases & {8, 9, 10}:
        model, params = full_width(RWKV_ARCH)
        if 8 in phases:
            rwkv_counts = phase_engine(model, params, 8)
        if 9 in phases:
            phase_consistency(model, params, 9)
        if 10 in phases:
            phase_profile(model, params, 10, "gla_scan kernel", ("gla_scan",))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if 11 in phases:
        phase_simulated()
    microgrid_launches = phase_sweeps() if 12 in phases else 0
    # phases 13-16: the other model families at full width
    served = {}
    for c in (counts, rwkv_counts):
        add_counts(served, c)
    if 13 in phases:
        model, params, c = serve_and_check(ZAMBA_ARCH, 13,
                                           ("gla_scan",) + ATTN_KERNELS)
        add_counts(served, c)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if 14 in phases:
        model, params, c = serve_and_check(MOE_ARCH, 14, ATTN_KERNELS)
        add_counts(served, c)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        model, params = full_width(MIXTRAL_ARCH, n_layers=MIXTRAL_LAYERS)
        add_counts(served, phase_window(model, params))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if 15 in phases:
        model, params, c = serve_and_check(VLM_ARCH, 15, ATTN_KERNELS)
        add_counts(served, c)
        add_counts(served, phase_vlm_grid(model, params))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if 16 in phases:
        model, params = full_width(AUDIO_ARCH)
        add_counts(served, phase_encoder(model, params))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if 17 in phases:
        add_counts(served, phase_train())
        add_counts(served, phase_train_f32())
    if 18 in phases:
        microgrid_launches += phase_audit_remote()
    print(f"chip_smoke phases {sorted(phases)} passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"kernel launches over the main paths' phases (served models, "
          f"training): {served}")
    kernels = []
    for name, source, replaces, row in (
            ("flash_attention", FLASH_SOURCE, FLASH_REPLACES, "flash_S2048"),
            ("flash_attention_bwd", FLASH_SOURCE, FLASH_BWD_REPLACES,
             "flash_bwd_smollm"),
            ("decode_attention", DECODE_SOURCE, DECODE_REPLACES, "decode"),
            ("gla_scan", GLA_SOURCE, GLA_REPLACES, "gla_T2048")):
        if rows and served.get(name):
            kernels.append(kernel_entry(name, source, replaces, served[name],
                                        rows[row]))
    if rows and microgrid_launches:
        kernels.append(kernel_entry("microgrid_scan", MICROGRID_SOURCE,
                                    MICROGRID_REPLACES, microgrid_launches,
                                    rows["microgrid"]))
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
