"""Multi-pod dry-run: trace every (arch x shape) cell once, abstractly, on
the production meshes and record its per-device memory, cost and
collectives.

Single cell (the card's device type; ``--torch-device cpu`` traces CPU
tensors, ``main(argv, device="cpu")`` from Python):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod]

All cells (a process each, as many at a time as the host has cores;
resumable):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records land in ``results/torch/dryrun/<mesh>/<arch>__<shape>.json``.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
for 512 forced host devices and reads XLA's analyses. Here the cell's
process joins a fake process group (``torch``'s ``fake`` backend: no rank
exists but this one, and no collective moves data) of 256 ranks (16x16) or
512 (2x16x16) as rank 0, builds ``launch.mesh.make_production_mesh`` over
it, and runs the cell's step once on fake tensors (``launch.specs``) under
``analysis.program``'s counter: every number is rank 0's local work and
memory. ``trace_s`` (the abstract run) replaces ``lower_s``/``compile_s``;
there is no HLO text. Attention is ``auto`` (the chunked plain path) or
``einsum``: the hand-written kernels have no fake form, so ``kernel`` is
refused, as the reference's dry-run cannot lower Pallas for host devices.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.log import configure as configure_logging
from repro_torch.obs.log import get_logger

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "torch" / "dryrun"
ATTN_IMPLS = ("auto", "einsum")

_log = get_logger("repro_torch.launch.dryrun")


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake process group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def trace_cell(cfg, shape, mesh, attn_impl: str = "auto",
               variant: str = "baseline", grad_accum=None,
               device: DeviceLike = None) -> dict:
    """Builds the cell on ``mesh`` (a process group must exist), traces its
    step once and returns the record's measured part."""
    from repro_torch.analysis.program import (TraceMode, collective_bytes,
                                              program_stats, trace_program)
    from repro_torch.launch.specs import build_cell
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl {attn_impl!r} cannot be traced "
                         f"abstractly (the kernels have no fake form); use "
                         f"one of {ATTN_IMPLS}")
    dev = resolve_device(device)
    fake_mode = TraceMode()
    plan, fn, args, _, _ = build_cell(cfg, shape, mesh, attn_impl=attn_impl,
                                      variant=variant, grad_accum=grad_accum,
                                      fake_mode=fake_mode, device=dev)
    t0 = time.perf_counter()
    out, trace = trace_program(fn, *args, fake_mode=fake_mode)
    trace_s = time.perf_counter() - t0
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": trace.peak_bytes,
            "code_bytes": None,
            "counted": "rank 0's local shards: argument_bytes of the params, "
                       "optimizer state, batch and cache; temp_bytes the "
                       "peak of the bytes held by the tensors the step "
                       "allocated, each from its creation until it was "
                       "freed (no allocator rounding or caching)",
        },
        "cost": {"flops": trace.dot_flops, "bytes_accessed": trace.hbm_bytes,
                 "transcendentals": trace.transcendentals},
        "collectives": collective_bytes(trace),
        "loop_aware": program_stats(trace),
        "ops": trace.ops,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attn_impl: str = "auto", out_path: Optional[Path] = None,
             variant: str = "baseline", grad_accum=None,
             device: DeviceLike = None) -> dict:
    from repro_torch.configs import cell_is_runnable, get_config, get_shape
    from repro_torch.launch.mesh import make_production_mesh

    dev = resolve_device(device)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "runnable": ok, "reason": reason, "attn_impl": attn_impl,
           "variant": variant}
    if not ok:
        return rec
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        rec.update(trace_cell(cfg, shape, mesh, attn_impl, variant,
                              grad_accum, dev))
    rec.update(n_devices=n, device=dev.type, torch=torch.__version__)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def orchestrate(multi_pod: bool, attn_impl: str, only_missing: bool = True,
                timeout: int = 3600, device: DeviceLike = None):
    """Every cell in a process of its own, as many at a time as the host
    has cores (a trace is one core's host work); a failed or timed-out cell
    is recorded and listed, the others go on."""
    from repro_torch.configs import all_cells
    dev = resolve_device(device)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    outdir = RESULTS / mesh_tag
    outdir.mkdir(parents=True, exist_ok=True)
    todo = []
    for arch, shape_name, ok, reason in all_cells():
        out_path = outdir / f"{arch}__{shape_name}.json"
        if only_missing and out_path.exists():
            rec = json.loads(out_path.read_text())
            if rec.get("runnable") is False or "trace_s" in rec:
                _log.info("[skip existing] %s %s", arch, shape_name)
                continue
        if not ok:
            out_path.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "runnable": False, "reason": reason}, indent=1))
            _log.info("[skip n/a] %s %s: %s", arch, shape_name, reason)
            continue
        todo.append((arch, shape_name, out_path))

    def run(arch, shape_name, out_path):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape_name,
               "--attn-impl", attn_impl, "--torch-device", dev.type]
        if multi_pod:
            cmd.append("--multi-pod")
        _log.info("[run] %s %s (%s)", arch, shape_name, mesh_tag)
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout,
                               env={**os.environ,
                                    "PYTHONPATH": str(ROOT / "src")})
        except subprocess.TimeoutExpired:
            _log.warning("TIMEOUT %s %s", arch, shape_name)
            return arch, shape_name, "timeout"
        if r.returncode != 0:
            out_path.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "runnable": True, "error": r.stderr[-3000:]}, indent=1))
            _log.warning("FAILED %s %s in %.0fs", arch, shape_name,
                         time.time() - t0)
            return arch, shape_name, r.stderr[-3000:]
        _log.info("ok %s %s in %.0fs", arch, shape_name, time.time() - t0)
        return None

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        done = list(pool.map(lambda job: run(*job), todo))
    return [f for f in done if f is not None]


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--torch-device", default=None,
                    help="device type the fake tensors stand for (default "
                         "cuda, which must exist)")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    configure_logging(verbosity=(-1 if args.quiet else args.verbose))
    dev = resolve_device(args.torch_device if device is None else device)

    if args.all:
        fails = orchestrate(args.multi_pod, args.attn_impl,
                            only_missing=not args.force, device=dev)
        if fails:
            print(f"{len(fails)} failures:")
            for a, s, e in fails:
                print(f"  {a} {s}: {e[:200]}")
            sys.exit(1)
        print("all cells ok")
        return

    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    if args.variant != "baseline":
        mesh_tag = f"{mesh_tag}-{args.variant}"
    out_path = RESULTS / mesh_tag / f"{args.arch}__{args.shape}.json"
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.attn_impl,
                   out_path, variant=args.variant,
                   grad_accum=args.grad_accum, device=dev)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
