"""Training launcher: a few fault-tolerant AdamW steps of a model on
synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --seq 2048 --batch 8 --ckpt-dir /tmp/ckpts

Counterpart of ``repro.launch.train``, with its flags. It runs on the card
(``main(argv, device="cpu")`` runs on the host, as the tests do). The
weights are float32 masters drawn on the device from a generator seeded
with 0, the compute dtype is the config's; attention trains through the
flash kernels (``FlashAttention``), RWKV6 and Mamba2 through the plain
chunked scan, as the reference. One card only: ``--mesh`` other than 1x1
raises (the distributed layer is not ported yet), and at 1x1 every
``--variant`` leaves the config as it is, as the reference's sharding plan
does at tensor-parallel 1 (its only config change, ``kv_repeat``, is 1
there).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                               FaultTolerantRunner)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step, param_dict


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="laptop-scale same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x4")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    if (d, m) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; the "
            "distributed layer is ROADMAP queue 1 step 12")
    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
          f"{dev} mesh 1x1 variant={args.variant}")

    params = param_dict(model.init(0, device=dev, dtype=torch.float32))
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(100, args.steps))
    step = make_train_step(model, opt_cfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch, seed=0))
    runner = FaultTolerantRunner(step, FaultToleranceConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 2)))
    params, opt, start = runner.try_restore(params, opt)
    if start >= args.steps:
        print(f"done: checkpoint already at step {start} (>= --steps)")
        return {"start_step": start, "final_step": start, "losses": [],
                "step_times": [], "runner": runner}
    out = runner.run(params, opt, ds.batch, n_steps=args.steps,
                     start_step=start)
    if out["losses"]:
        print(f"done: step {out['final_step']}, loss "
              f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    else:
        print(f"done: step {out['final_step']} (no new steps)")
    return dict(out, start_step=start, runner=runner)


if __name__ == "__main__":
    main()
