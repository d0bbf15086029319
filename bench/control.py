#!/usr/bin/env python3
"""The readings an output check's limits are set from, at a cell's own size.

    python3 bench/control.py --workload <name> --seconds <s> \\
        [--seeds <n> ...] [--kv-seeds <n> ...] \\
        [--fault <name> --fault-seeds <n> ...]

Each seed runs the cell as ``run.py`` does, in this one process, up to the
window's close, with a window of ``--seconds``, and prints one JSON line:

- ``--seeds``: the check's numbers for the program's served tokens and
  cache rows, and the control's: the plain reference computed in float8
  (e4m3: the precision below the configuration's bf16) put in the
  program's place, each position read at the token it puts first, its k
  and v in the cache's place; the gaps' distribution beside them.
- ``--kv-seeds``: the cache number alone (``kv_rel_err_layer0``, and the
  worst layer's beside it), for the program
  and, on the first ``KV_CONTROLS`` of these seeds, for the control.
- ``--fault-seeds``: a whole run with ``--fault`` planted in the program
  (``FAULTS``), its ``correct`` and the numbers compared.

The benchmark's own runs do not run this.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import run  # noqa: E402  (sets the paths and caches)


def _lose_decode_writes():
    """A decode step that leaves the K/V cache unchanged."""
    from repro_torch.models import attention
    return attention, "cache_insert_decode", \
        lambda ck, cv, kn, vn, lengths, window: (ck, cv)


def _lose_prefill_writes():
    """A prefill that leaves the K/V cache unchanged."""
    from repro_torch.models import transformer
    return transformer, "write_prefill_to_cache", lambda *args: None


KV_CONTROLS = 4          # --kv-seeds that read the control too

FAULTS = {"decode_kv_lost": _lose_decode_writes,
          "prefill_kv_lost": _lose_prefill_writes}


@contextlib.contextmanager
def planted(fault):
    mod, name, broken = FAULTS[fault]()
    orig = getattr(mod, name)
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def kv_number(check, s, ref_kv, fp8_kv=None):
    """``kv_rel_err_layer0`` of the program's cache rows against the
    reference's k and v, the worst layer's and the errors by layer; with
    ``fp8_kv``, the control's."""
    import numpy as np
    snap = s.snap
    P = len(snap.prompt)
    err = check.kv_errors(snap.k, snap.v, ref_kv, P)
    out = {"kv_rel_err_layer0": float(np.nanmax(err[0])),
           "kv_rel_err_worst_layer": float(np.nanmax(err)),
           "kv_by_layer": check.describe_kv(err)}
    if fp8_kv is not None:
        ctl = check.kv_errors([k for k, _ in fp8_kv], [v for _, v in fp8_kv],
                              ref_kv, P)
        out.update(control_kv_rel_err_layer0=float(np.nanmax(ctl[0])),
                   control_kv_rel_err_worst_layer=float(np.nanmax(ctl)),
                   control_kv_by_layer=check.describe_kv(ctl))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--kv-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from bench import check
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    stats = lambda g: {"max": float(g.max()), "mean": float(g.mean()),
                       "q90": float(np.quantile(g, 0.9)),
                       "q99": float(np.quantile(g, 0.99)),
                       "flips": float((g > 0).mean())}
    head = lambda seed, mode: {"workload": args.workload, "seed": seed,
                               "mode": mode}
    for seed in args.seeds:
        s = run.serve(args.workload, seed, args.seconds, False)
        picked = check.sample(s.rec.done_in_window, np.random.default_rng(seed),
                              s.limits["check"]["served_tokens"],
                              s.limits["check"]["sequence_tokens"])
        t = time.perf_counter()
        logits, ref_kv = check.reference_pass(s.ref, s.W, s.cfg, picked, s.snap)
        low, fp8_kv = check.reference_pass(s.ref, s.W, s.cfg, picked, s.snap,
                                           fp8=True)
        gaps = np.concatenate(check.served_gaps(s.ref, logits, picked))
        ctl = np.concatenate(check.control_gaps(s.ref, logits, low))
        print(json.dumps({
            **head(seed, "full"), "requests": len(picked),
            "served_tokens": int(gaps.size),
            "program_numbers": check.numbers(gaps),
            "control_numbers": check.numbers(ctl),
            "program": stats(gaps), "control": stats(ctl),
            **kv_number(check, s, ref_kv, fp8_kv),
            "reference_s": time.perf_counter() - t}), flush=True)
        del s, picked, logits, low, ref_kv, fp8_kv
        gc.collect()
        torch.cuda.empty_cache()
    for i, seed in enumerate(args.kv_seeds):
        s = run.serve(args.workload, seed, args.seconds, False)
        t = time.perf_counter()
        _, ref_kv = check.reference_pass(s.ref, s.W, s.cfg, [], s.snap)
        fp8_kv = (check.reference_pass(s.ref, s.W, s.cfg, [], s.snap, fp8=True)[1]
                  if i < KV_CONTROLS else None)
        print(json.dumps({
            **head(seed, "kv"), "prompt": len(s.snap.prompt),
            "served": len(s.snap.tokens),
            **kv_number(check, s, ref_kv, fp8_kv),
            "reference_s": time.perf_counter() - t}), flush=True)
        del s, ref_kv, fp8_kv
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        with planted(args.fault):
            result = run.run_cell(args.workload, seed, args.seconds, False)
        print(json.dumps({**head(seed, f"fault {args.fault}"),
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
