#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process finds.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names a
configuration (``bench/configs/<config>.json``, whose ``family`` names the
reference and the program adapter under ``bench/reference/`` and
``bench/program/``), a traffic mix (``bench/traffic/<mix>.json``) and the
limits of its output check (``bench/cells/<workload>.json``); each metric
is read by ``bench/metrics/<metric>.py``.

The run: the kernel libraries built or loaded; the weights drawn on the card
from the seed; a ``ServingEngine`` with the mix's slots; the mix's closed
loop driven until every client has finished one request (the warm-up);
with ``--trace 1`` a profiled slice of the loop; then the measured window of
``--seconds``, the card's energy read at its ends. Once the window has
closed: the peak memory read, the engine's cache freed, and a sample of the
requests finished in the window held against the plain float32 reference.
The last line of standard output is the result, as JSON; a run that cannot
measure (no card, too few cards, JAX loaded) exits 1 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
SLICE_S = 2.0            # the profiled slice, --trace 1
KERNELS = ("flash_attention", "decode_attention")
FLASH_KERNEL, DECODE_KERNEL = "flash_fwd_wgmma_kernel", "decode_mma_kernel"


def load_cell(workload: str, root: Path = ROOT):
    """(benchmark, cell, configuration, mix, check limits) of ``workload``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "cells" / f"{workload}.json").read_text())
    return spec, cell, cfg, mix, limits


def family(cfg):
    """(reference, program) modules of the configuration's family."""
    return (importlib.import_module(f"bench.reference.{cfg['family']}"),
            importlib.import_module(f"bench.program.{cfg['family']}"))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"unavailable ({err})"


class Record:
    """What the metric readers read: the window's iterations and requests,
    its energy, the set-up time, the profiled slice, the configuration."""

    def __init__(self, cfg, ref, loop, t_open, t_close, joules, setup_s,
                 slice_):
        self.cfg, self.ref = cfg, ref
        self.seconds = t_close - t_open
        self.iterations = [it for it in loop.iterations
                           if t_open <= it.t0 and it.t1 <= t_close]
        self.first_in_window = [s for s in loop.served.values()
                                if t_open <= s.t_first <= t_close]
        self.done_in_window = [s for s in loop.served.values()
                               if t_open <= s.t_done <= t_close]
        self.joules, self.setup_s, self.slice = joules, setup_s, slice_

    def of(self, kind):
        return [it for it in self.iterations if it.kind == kind]

    @property
    def tokens(self):
        return sum(it.tokens for it in self.iterations)


def profile_slice(loop, cfg, ref, seconds: float = SLICE_S):
    """Per-layer readings of a profiled slice of the loop (run after the
    warm-up): each kernel's device seconds and bound seconds, the device's
    busy seconds, the slice's wall, and the breakdown."""
    from bench import profile, roofline
    d = ref.dims(cfg)
    its = []

    # at least ``seconds``, and until the slice holds a prefill and, where
    # the cell decodes, a decode step: each kernel's reader finds its work
    kinds = {i.kind for i in loop.iterations}

    def run():
        start, t0 = len(loop.iterations), time.perf_counter()
        while (time.perf_counter() - t0 < seconds or
               kinds - {i.kind for i in loop.iterations[start:]}):
            loop.step()
        its[:] = loop.iterations[start:]

    def whole(device):
        names = profile.by_kernel_counts(device)
        return (names.get(FLASH_KERNEL, 0) == d.L * sum(i.kind == "prefill" for i in its)
                and names.get(DECODE_KERNEL, 0) == d.L * sum(i.kind == "decode" for i in its))

    t = time.perf_counter()
    traced = profile.profiled(run, f"{seconds} s of the loop", whole)
    if traced is None:
        return None
    device, host, wall_ms, attempts = traced
    busy = profile.busy_intervals(device)
    kernels = profile.by_kernel(device)
    W = loop.engine.max_len if d.window is None else min(d.window, loop.engine.max_len)
    out = {
        "attempts": attempts, "wall_s": wall_ms * 1e-3,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "prefills": sum(i.kind == "prefill" for i in its),
        "decodes": sum(i.kind == "decode" for i in its),
        "flash_s": kernels.get(FLASH_KERNEL, 0.0),
        "flash_bound_s": d.L * sum(
            roofline.flash_fwd_s(i.prompt, d.H, d.KV, d.Dh, True, d.window)
            for i in its if i.kind == "prefill"),
        "decode_s": kernels.get(DECODE_KERNEL, 0.0),
        "decode_bound_s": d.L * sum(
            roofline.decode_attn_s([min(n, W) for n in i.keys], d.H, d.KV, d.Dh)
            for i in its if i.kind == "decode"),
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": profile.idle_by_host(busy, host)},
    }
    print(f"profiled slice: {out['prefills']} prefills, {out['decodes']} "
          f"decodes, {len(device)} device operations, wall {out['wall_s']} s, "
          f"busy {out['busy_s']} s; read in {time.perf_counter() - t:.1f} s")
    return out


def describe(rec, mem):
    """Lines on how the window's steps were spent, and the allocator's
    device calls over the run."""
    import numpy as np
    for kind in ("prefill", "decode"):
        its = rec.of(kind)
        if its:
            ms = np.array([(i.t1 - i.t0) * 1e3 for i in its])
            print(f"window {kind}: {len(its)} steps, ms mean {ms.mean():.2f} "
                  f"p50 {np.median(ms):.2f} p90 {np.quantile(ms, 0.9):.2f} "
                  f"max {ms.max():.2f}, tokens {sum(i.tokens for i in its)}")
    gaps = [(b.t0 - a.t1) * 1e3 for a, b in zip(rec.iterations, rec.iterations[1:])]
    if gaps:
        print(f"window host time between steps: {sum(gaps):.1f} ms in all, "
              f"max {max(gaps):.2f} ms")
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
            "reserved_bytes.all.peak")
    print("allocator: " + ", ".join(f"{k} {mem.get(k)}" for k in keys))


def kv_snapshot(engine):
    """The cache rows of one request as they stand at the window's close,
    for the check: of the busy slots, the request with the most tokens
    served (its prompt's rows and every decode step's); where no slot is
    busy (every request retires at its prefill), the request retired last,
    in the last step, whose rows no step has written since. A namespace of
    its prompt, its served tokens and the K and V (L, n, KV, Dh) of its
    n = P + served - 1 positions (the last served token is not fed back
    yet), a copy."""
    busy = [r for r in engine.slots if r is not None]
    r = (max(busy, key=lambda r: (len(r.generated), len(r.prompt)))
         if busy else engine.done[-1])
    n = len(r.prompt) + len(r.generated) - 1
    if n > engine.cache["k"].shape[2]:
        raise ValueError("the request's rows wrapped round a ring cache; "
                         "the check reads a request that fits the cache")
    return SimpleNamespace(prompt=list(r.prompt), tokens=list(r.generated),
                           k=engine.cache["k"][:, r.slot, :n].clone(),
                           v=engine.cache["v"][:, r.slot, :n].clone())


def free(loop):
    """Drop the engine and its cache; the weights stay for the check."""
    loop.engine = None
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve(workload: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda", cfg=None):
    """The run up to the window's close and the engine freed: a namespace
    of the cell's files, the weights (``W``), the window's ``Record`` and
    the peak memory. ``cfg``, where given, takes the place of the cell's
    configuration (the CPU tests run a reduced one)."""
    import torch
    from bench import loop as loop_mod, traffic
    from repro_torch.serve.engine import ServingEngine
    spec, cell, cell_cfg, mix, limits = load_cell(workload)
    cfg = cfg or cell_cfg
    ref, program = family(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    if cuda:
        from repro_torch.kernels import _build
        t = time.perf_counter()
        _build.build(KERNELS)
        print(f"kernels {', '.join(KERNELS)} built or loaded in "
              f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    W = ref.draw(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    print(f"weights: {sum(w.numel() for w in W.values())} parameters drawn in "
          f"{time.perf_counter() - t:.2f} s")
    model, params = program.build(cfg, W)
    engine = ServingEngine(model, params, max_slots=mix["slots"],
                           max_len=mix["max_len"], device=device)
    loop = loop_mod.ClosedLoop(
        engine, traffic.stream(mix, seed, ref.dims(cfg).V), mix["clients"])
    t = time.perf_counter()
    loop.warm_up()
    print(f"warm-up: {len(loop.iterations)} steps, {len(engine.done)} "
          f"requests in {time.perf_counter() - t:.1f} s")
    slice_ = profile_slice(loop, cfg, ref) if trace and cuda else None
    meter = None
    if cuda:
        from bench.energy import EnergyMeter
        uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
        meter = EnergyMeter(None if uuid is None else f"GPU-{uuid}")
        print(f"energy source: {meter.source}")
        meter.start()
    setup_s = time.perf_counter() - T_START
    t_open, t_close = loop.run(seconds)
    joules = meter.stop() if meter else None
    if meter:
        meter.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = Record(cfg, ref, loop, t_open, t_close, joules, setup_s, slice_)
    print(f"window: {rec.seconds} s, {len(rec.iterations)} steps, "
          f"{len(rec.done_in_window)} requests finished, {rec.tokens} tokens, "
          f"{joules} J; peak {peak} bytes")
    describe(rec, torch.cuda.memory_stats() if cuda else {})
    snap = kv_snapshot(engine)
    del engine
    free(loop)
    return SimpleNamespace(spec=spec, cell=cell, cfg=cfg, ref=ref,
                           limits=limits, W=W, rec=rec, peak=peak, cuda=cuda,
                           snap=snap)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg=None):
    """One run of ``workload``; returns the result's dict."""
    import numpy as np
    import torch
    from bench import check
    from bench.readers import reader
    s = serve(workload, seed, seconds, trace, device, cfg)
    rec = s.rec
    t = time.perf_counter()
    checks = check.check(s.ref, s.W, s.cfg, rec.done_in_window,
                         s.limits["check"], np.random.default_rng(seed), s.snap)
    print(f"check: {time.perf_counter() - t:.1f} s")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in s.spec[kind]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(rec.done_in_window),
        "failed": sum(len(r.tokens) != r.new_tokens for r in rec.done_in_window),
        "metrics": metrics,
        "device": {"platform": "gpu" if s.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if s.cuda else "cpu",
                   "count": 1, "memory_peak_bytes": s.peak},
    }
    if rec.slice is not None:
        result["device"].update(busy_s=rec.slice["busy_s"],
                                window_s=rec.slice["wall_s"])
        result["breakdown"] = rec.slice["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi name, "
          f"power.limit: {nvidia_smi('name,power.limit')}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: modules {loaded} are loaded", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
