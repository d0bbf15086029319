"""Serving launcher: the continuous-batching engine over a selectable
architecture, with energy accounting of the served trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --no-reduced --slots 8 --max-len 4096 --requests 16 --new-tokens 32

Serves every decoder family (dense, MoE, VLM with text tokens, RWKV6,
Zamba2); an encoder-only model (HuBERT) is refused before any weight is
drawn. Counterpart of ``repro.launch.serve`` with two faults of the
reference fixed:
``--reduced`` can be turned off (``--no-reduced`` serves the full model),
and the default power profile is the H100 the port runs on.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import PowerModel, emissions
from repro_torch.core.power import DEVICES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeRequest, ServingEngine


def energy_report(engine: ServingEngine, cfg, device_profile: str, ci: float):
    """Eq. 1 power over each iteration's MFU, Eq. 3 energy, Eq. 4 carbon."""
    dev = DEVICES[device_profile]
    durs = np.array([l.dur_s for l in engine.logs])
    flops = np.array([2.0 * cfg.param_count() * l.n_tokens
                      for l in engine.logs])
    mfu = np.clip(flops / (np.maximum(durs, 1e-9) * dev.peak_flops), 0, 1)
    # the served trace is priced on the host, one float32 Eq. 1 per iteration
    watts = PowerModel(dev, torch_device="cpu").power(mfu).numpy()
    wh = float(np.sum(watts * durs)) / 3600.0
    return wh, emissions(wh, engine.clock / 3600.0, dev, ci=ci), dev


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="h100",
                    help="power profile for Eq. 1 (repro_torch.core.power)")
    ap.add_argument("--ci", type=float, default=400.0,
                    help="grid carbon intensity gCO2/kWh")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    engine = ServingEngine(model, params, max_slots=args.slots,
                           max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(ServeRequest(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, rng.integers(4, 17)),
            max_new_tokens=args.new_tokens))
    done = engine.run()
    toks = sum(len(r.generated) for r in done)
    tok_s = toks / max(engine.clock, 1e-9)
    print(f"{cfg.name}: {len(done)} requests, {toks} tokens, {tok_s:.1f} tok/s")

    wh, rep, prof = energy_report(engine, cfg, args.device, args.ci)
    print(f"energy {wh*1000:.2f} mWh -> {rep.total_g:.4f} gCO2 "
          f"(CI={args.ci:.0f}, device={prof.name})")
    return {"requests": len(done), "tokens": toks, "tok_s": tok_s,
            "energy_wh": wh, "carbon": rep, "engine": engine}


if __name__ == "__main__":
    main()
