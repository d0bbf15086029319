"""Training launcher: a few fault-tolerant AdamW steps of a model on
synthetic data, on one device or on a (data, model) mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --seq 2048 --batch 8 --ckpt-dir /tmp/ckpts
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m --mesh 2x2 --variant baseline

Counterpart of ``repro.launch.train``, with its flags. It runs on the card
(``main(argv, device="cpu")`` runs on the host, as the tests do). The
weights are float32 masters drawn on the device from a generator seeded
with 0, the compute dtype is the config's; attention trains through the
flash kernels (``FlashAttention``), RWKV6 and Mamba2 through the plain
chunked scan, as the reference.

With no process group and ``--mesh 1x1`` the step runs on plain tensors.
Otherwise (a group initialised by the caller, or by this launcher from
torchrun's environment) it runs on ``DTensor``s over a ``("data",
"model")`` ``DeviceMesh`` of D x M ranks, one per device (NCCL on
``cuda:LOCAL_RANK``; gloo when ``device="cpu"``): the sharding plan
(``distributed.sharding.make_plan``, its ``--variant`` included: the
``kv_repeat`` of head-mode tensor parallelism, ``dp``, ``hd``, ``sp``)
places the float32 masters and AdamW moments, each data rank takes its rows
of the one global batch, and the step runs under the plan's ``axis_env``, so
the loss is the one-device loss. Checkpoints hold the whole tensors, written
by rank 0.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.axes import axis_env
from repro_torch.distributed.sharding import (batch_pspecs, make_plan,
                                              param_pspecs)
from repro_torch.models import build_model
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                               FaultTolerantRunner)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import batch_to, make_train_step, param_dict


def _rank_device(device: DeviceLike) -> torch.device:
    """This rank's device: the CPU when asked, else ``cuda:LOCAL_RANK``,
    which must exist."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    resolve_device("cuda")
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local} needs cuda:{local}; this machine "
                           f"has {torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", local)


def sharded_step(step, plan, device: torch.device):
    """``step`` (``make_train_step``'s) on a mesh: each rank takes its rows
    of the global batch (the plan's batch specs) and the step runs under
    the plan's axis env."""
    def run(params, opt_state, batch):
        b = batch_to(batch, device)
        b = plan.distribute(b, batch_pspecs(plan.cfg, plan.mapping, b))
        with axis_env(plan.mesh, plan.mapping):
            return step(params, opt_state, b)
    return run


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
    # torchrun's environment without a group yet: this launcher joins it
    started = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if started:
        dev = _rank_device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                device_id=dev if dev.type == "cuda" else None)
    try:
        if dist.is_initialized() or (d, m) != (1, 1):
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world != d * m:
                raise RuntimeError(f"--mesh {args.mesh} needs {d * m} ranks; "
                                   f"this world has {world}")
            return _train(args, _rank_device(device), (d, m))
        return _train(args, resolve_device(device), None)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, dev: torch.device, mesh_shape) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    plan = None
    if mesh_shape is not None:
        mesh = init_device_mesh(dev.type, mesh_shape,
                                mesh_dim_names=("data", "model"))
        shape = ShapeConfig("cli", args.seq, args.batch, "train")
        plan = make_plan(cfg, mesh, "train", shape, variant=args.variant)
        cfg = plan.cfg
    model = build_model(cfg)
    where = (f"{dist.get_world_size()} ranks on {dev.type}, mesh "
             f"{mesh_shape[0]}x{mesh_shape[1]}" if plan else f"{dev} mesh 1x1")
    log(f"training {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
        f"{where} variant={args.variant}")

    params = param_dict(model.init(0, device=dev, dtype=torch.float32))
    if plan is not None:
        params = plan.distribute(params, param_pspecs(params, plan.mapping))
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(100, args.steps))
    step = make_train_step(model, opt_cfg)
    if plan is not None:
        step = sharded_step(step, plan, dev)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch, seed=0))
    runner = FaultTolerantRunner(step, FaultToleranceConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 2)))
    params, opt, start = runner.try_restore(params, opt)
    if start >= args.steps:
        log(f"done: checkpoint already at step {start} (>= --steps)")
        return {"start_step": start, "final_step": start, "losses": [],
                "step_times": [], "runner": runner, "plan": plan}
    out = runner.run(params, opt, ds.batch, n_steps=args.steps,
                     start_step=start, log_fn=log)
    if out["losses"]:
        log(f"done: step {out['final_step']}, loss "
            f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    else:
        log(f"done: step {out['final_step']} (no new steps)")
    return dict(out, start_step=start, runner=runner, plan=plan)


if __name__ == "__main__":
    main()
