"""Analytical batch-stage execution model (the Vidur random-forest
replacement — see DESIGN.md §3.2).

Stage latency is a three-term roofline over the batch composition:

  t_compute = FLOPs / (eff(tokens) * peak * TP)        per pipeline stage
  t_memory  = bytes(weights/TP + KV + activations) / (HBM_bw * TP)
  t_coll    = TP all-reduce traffic / link_bw (+ PP activation handoff)
  t_stage   = max(t_compute, t_memory) + (1 - overlap) * t_coll + t_0

The matmul efficiency curve eff(tokens) saturates with batched tokens
(arithmetic intensity): calibrated so Meta-Llama-3-8B on A100 plateaus
near MFU 0.45 at 5-8 QPS, reproducing the paper's Fig. 1. On TPU the
same form is calibrated against the dry-run's compiled cost analysis
(`calibrate_from_dryrun`).

Array-native core: a stage's composition reduces to four aggregates —
summed prefill tokens, decode count, score FLOPs, KV read/write bytes
(``StageBatch``) — and the roofline over those aggregates is a pure
elementwise kernel (``stage_cost_batch``) that evaluates ONE stage or a
whole trace of stages in a single numpy pass (or in torch on a device).
The scalar ``stage_cost`` is a thin length-1 view over the batched
kernel, so scalar (event-loop) and batched (sweep replay) paths are
bit-identical by construction.

All per-model constants (active parameter count, KV bytes/token,
per-token FLOP totals, score coefficients) are computed once at
``ExecutionModel`` construction, not per stage-cost call.

Counterpart of ``repro.sim.execmodel``: the numpy roofline and
``stage_cost_scalar`` are verbatim, so timings are bit-identical to the
reference's; its ``backend="jax"`` becomes ``backend="torch"``, the same
kernel in float64 torch on ``torch_device``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.power import DEVICES, DeviceProfile
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ExecModelConfig:
    eff_max: float = 0.52          # peak matmul efficiency (fraction of peak)
    eff_half_tokens: float = 192.0  # tokens at which eff reaches half of max
    stage_overhead_s: float = 200e-6
    activation_bytes_factor: float = 8.0  # bytes/token/layer ~ f*d_model
    collective_overlap: float = 0.0       # 0 = no overlap (baseline)
    kv_dtype_bytes: int = 2
    weight_dtype_bytes: int = 2


@dataclasses.dataclass
class StageCost:
    t_total: float
    t_compute: float
    t_memory: float
    t_collective: float
    flops_mlp: float
    flops_attn: float
    mfu: float


@dataclasses.dataclass
class StageBatch:
    """Per-stage batch-composition aggregates, over N stages.

    These four arrays — plus the per-model invariants cached on the
    ``ExecutionModel`` — fully determine the roofline, so a logged
    trace of them can be re-costed in one array pass.
    """
    prefill_tokens: np.ndarray   # summed prefill (chunk) tokens per stage
    decode_count: np.ndarray     # sequences decoding one token per stage
    score_flops: np.ndarray      # context-dependent attention score FLOPs
    kv_rw_bytes: np.ndarray      # KV cache read+write traffic per stage

    def __len__(self) -> int:
        return len(self.prefill_tokens)

    @classmethod
    def concat(cls, batches: Sequence["StageBatch"]) -> "StageBatch":
        return cls(*(np.concatenate([getattr(b, f.name) for b in batches])
                     for f in dataclasses.fields(cls)))

    @classmethod
    def from_trace(cls, trace) -> "StageBatch":
        """Rebuild the aggregates from a logged ``StageTrace``."""
        return cls(
            prefill_tokens=np.asarray(trace.n_prefill_tokens, np.float64),
            decode_count=np.asarray(trace.n_decode_tokens, np.float64),
            score_flops=np.asarray(trace.score_flops, np.float64),
            kv_rw_bytes=np.asarray(trace.kv_rw_bytes, np.float64))


@dataclasses.dataclass
class StageCostBatch:
    """Roofline outputs over N stages (arrays aligned with StageBatch)."""
    t_total: np.ndarray
    t_compute: np.ndarray
    t_memory: np.ndarray
    t_collective: np.ndarray
    flops_mlp: np.ndarray
    flops_attn: np.ndarray
    mfu: np.ndarray

    def __len__(self) -> int:
        return len(self.t_total)

    def row(self, i: int = 0) -> StageCost:
        return StageCost(
            t_total=float(self.t_total[i]),
            t_compute=float(self.t_compute[i]),
            t_memory=float(self.t_memory[i]),
            t_collective=float(self.t_collective[i]),
            flops_mlp=float(self.flops_mlp[i]),
            flops_attn=float(self.flops_attn[i]),
            mfu=float(self.mfu[i]))


@dataclasses.dataclass(frozen=True)
class _Params:
    """Scalar roofline parameters, resolved once per ExecutionModel.
    The kernel below reads only this (plus the StageBatch arrays), so
    the numpy and torch paths share one implementation."""
    fpt_mlp: float
    fpt_proj: float
    weight_bytes: float
    act_bytes_per_token: float
    coll_s_per_token: float
    coll_scale: float
    overhead_s: float
    eff_max: float
    eff_half_tokens: float
    peak_chips: float
    hbm_chips: float
    pp: float


#: flat field order of the roofline parameter vector
#: (``ExecutionModel.params_vector`` / the device-mode batched program,
#: which reconstructs ``_Params(*row)`` per trace group inside vmap)
PARAMS_FIELDS = tuple(f.name for f in dataclasses.fields(_Params))

#: relative tolerance for ``stage_cost_batch(backend="torch")`` against
#: the ``"numpy"`` reference, the reference's ``JAX_BACKEND_RTOL``: the
#: torch kernel runs in float64, so it sits far inside the bound the
#: reference set for its float32 jax kernel (a few f32 ulps over the
#: roofline's ~6 chained elementwise ops).
TORCH_BACKEND_RTOL = 1e-5


def _roofline(prefill_tokens, decode_count, score_flops, kv_rw_bytes,
              p, xp=np):
    """The three-term roofline, elementwise over stages. ``xp`` is
    ``numpy`` (default) or ``torch`` — same ops either way."""
    tokens = prefill_tokens + decode_count
    live = tokens > 0
    safe_tokens = xp.where(live, tokens, 1.0)

    f_mlp = tokens * p.fpt_mlp
    f_attn = tokens * p.fpt_proj + score_flops
    flops_st = (f_mlp + f_attn) / p.pp
    mem_st = (p.weight_bytes + kv_rw_bytes
              + tokens * p.act_bytes_per_token) / p.pp

    eff = p.eff_max * safe_tokens / (safe_tokens + p.eff_half_tokens)
    t_comp = flops_st / (eff * p.peak_chips)
    t_mem = mem_st / p.hbm_chips
    t_coll = tokens * p.coll_s_per_token
    t = (xp.maximum(t_comp, t_mem) + p.coll_scale * t_coll
         + p.overhead_s)
    mfu = flops_st / (p.peak_chips * xp.where(live, t, 1.0))

    zero = xp.zeros_like(tokens)
    out = []
    for v in (t, t_comp, t_mem, t_coll, f_mlp / p.pp, f_attn / p.pp, mfu):
        out.append(xp.where(live, v, zero))
    return tuple(out)


class ExecutionModel:
    def __init__(self, model: ModelConfig, device: DeviceProfile,
                 tp: int = 1, pp: int = 1,
                 cfg: ExecModelConfig = ExecModelConfig()):
        self.model = model
        self.dev = device
        self.tp = tp
        self.pp = pp
        self.cfg = cfg

        # ---- per-model invariants, computed ONCE (not per stage) ----
        m, c = model, cfg
        self.active_params = m.active_param_count()
        self.kv_bytes_per_token = float(m.kv_bytes_per_token(c.kv_dtype_bytes))
        self.fpt_mlp = m.flops_per_token_mlp_total()
        self.fpt_proj = m.flops_per_token_attn_proj_total()
        # score(ctx) = score_coef * min(ctx, window) + score_const:
        # the context-linear attention part plus the constant ssm/rwkv
        # per-token mixing terms (flops_attn_score_per_token's shape)
        self.score_const = float(m.flops_attn_score_per_token(0))
        self.score_coef = float(m.flops_attn_score_per_token(1)
                                - self.score_const)
        a = m.attention
        self.sliding_window = (float(a.sliding_window)
                               if (a and a.sliding_window) else math.inf)

        chips = tp
        coll = 0.0
        if tp > 1:
            # 2 all-reduces per layer of the activation block (ring)
            coll += (2.0 * m.d_model * 2 * (m.n_layers / pp)
                     * 2.0 * (tp - 1) / tp) / device.link_bw
        if pp > 1:
            coll += m.d_model * 2 / device.link_bw
        self._params = _Params(
            fpt_mlp=float(self.fpt_mlp),
            fpt_proj=float(self.fpt_proj),
            weight_bytes=float(self.active_params * c.weight_dtype_bytes),
            act_bytes_per_token=float(m.n_layers * m.d_model
                                      * c.activation_bytes_factor),
            coll_s_per_token=float(coll),
            coll_scale=float(1.0 - c.collective_overlap),
            overhead_s=float(c.stage_overhead_s),
            eff_max=float(c.eff_max),
            eff_half_tokens=float(c.eff_half_tokens),
            peak_chips=float(device.peak_flops * chips),
            hbm_chips=float(device.hbm_bw * chips),
            pp=float(pp))

    def _eff(self, tokens: float) -> float:
        c = self.cfg
        return c.eff_max * tokens / (tokens + c.eff_half_tokens)

    def params_vector(self) -> np.ndarray:
        """The resolved roofline parameters as a flat float64 vector in
        ``PARAMS_FIELDS`` order — the per-group row the device-mode
        sweep stacks into its (groups, params) tensor."""
        return np.array([getattr(self._params, name)
                         for name in PARAMS_FIELDS], np.float64)

    def replica_tokens_per_s(self, batch_cap: int, kv_budget_tokens: int,
                             mean_prefill: float, mean_decode: float
                             ) -> float:
        """Model-derived steady-state per-replica token throughput at
        full batching: ``B`` requests of the mean shape served per
        ``t_prefill(B*L) + D * t_decode(B @ mid-context)`` seconds,
        with ``B`` capped by the batch cap and the KV budget.

        Used by the day planner's saturation guard as a *capacity
        floor* alongside the autoscaler's configured estimate — a
        config estimate far above what the roofline can actually
        serve would otherwise let a queue-saturated epoch slip
        through the fluid path (whose pilot tiles a growing queue).
        """
        L = max(float(mean_prefill), 1.0)
        D = max(float(mean_decode), 1.0)
        per_req = L + D
        b = min(float(batch_cap), float(kv_budget_tokens) / per_req)
        b = max(1.0, np.floor(b))
        t_pre = self.stage_cost_scalar([L] * int(b), [])[0].t_total
        mid_ctx = L + np.floor(D / 2.0)
        t_dec = self.stage_cost_scalar([], [mid_ctx] * int(b))[0].t_total
        return b * per_req / max(t_pre + D * t_dec, 1e-9)

    def _score_per_token(self, ctx):
        """score FLOPs per token at context length(s) ctx (array op)."""
        return (self.score_coef * np.minimum(ctx, self.sliding_window)
                + self.score_const)

    def aggregate(self, prefill_lens: Sequence[int],
                  decode_ctxs: Sequence[int],
                  prefill_offsets: Optional[Sequence[int]] = None
                  ) -> StageBatch:
        """Reduce ONE stage's composition to its StageBatch aggregates
        (length-1 arrays).

        prefill_lens: prompt (chunk) token counts prefilled this stage.
        decode_ctxs: context lengths of sequences generating one token.
        prefill_offsets: tokens of each prompt ALREADY prefilled by
        earlier chunks (Sarathi chunking); 0/None = fresh prefill. A
        chunk at offset o attends over the o previously-prefilled
        context tokens, so it re-reads their KV (the cross-chunk read
        term) and its score FLOPs see an average context of o + L/2
        instead of L/2.
        """
        plens = np.asarray(prefill_lens, np.float64)
        ctxs = np.asarray(decode_ctxs, np.float64)
        if prefill_offsets is None:
            offs = np.zeros_like(plens)
        else:
            offs = np.asarray(prefill_offsets, np.float64)

        npt = float(np.sum(plens))
        nd = float(len(ctxs))

        # causal prefill: average context = offset + L/2
        avg_ctx = np.maximum(offs + np.floor(plens / 2.0), 1.0)
        f_score = (float(np.sum(plens * self._score_per_token(avg_ctx)))
                   + float(np.sum(self._score_per_token(ctxs))))

        kvpt = self.kv_bytes_per_token
        w = self.sliding_window
        # prefill writes its chunk's K/V and re-reads the already-
        # prefilled context (bounded by the attention window)
        kv_pre = np.sum(plens * kvpt + np.minimum(offs, w) * kvpt)
        # decode reads the cache (window-bounded) + writes one token
        kv_dec = np.sum(np.minimum(ctxs, w) * kvpt + kvpt)
        kv_rw = float(kv_pre + kv_dec)

        return StageBatch(prefill_tokens=np.array([npt]),
                          decode_count=np.array([nd]),
                          score_flops=np.array([f_score]),
                          kv_rw_bytes=np.array([kv_rw]))

    def stage_cost_batch(self, batch: StageBatch, backend: str = "numpy",
                         torch_device: DeviceLike = None) -> StageCostBatch:
        """Evaluate the roofline over N stages in one array pass.

        ``backend="numpy"`` (default) is the reference path — bit-
        identical to the scalar ``stage_cost``. ``backend="torch"`` runs
        the same kernel in float64 on ``torch_device`` (``None``: the
        card) and returns numpy arrays, within ``TORCH_BACKEND_RTOL``.
        """
        args = (np.asarray(batch.prefill_tokens, np.float64),
                np.asarray(batch.decode_count, np.float64),
                np.asarray(batch.score_flops, np.float64),
                np.asarray(batch.kv_rw_bytes, np.float64))
        if backend == "numpy":
            return StageCostBatch(*_roofline(*args, self._params, np))
        if backend == "torch":
            dev = resolve_device(torch_device)
            out = _roofline(*(torch.as_tensor(a, device=dev) for a in args),
                            self._params, torch)
            return StageCostBatch(*(v.cpu().numpy() for v in out))
        raise ValueError(f"unknown backend {backend!r}")

    def stage_cost(self, prefill_lens: Sequence[int],
                   decode_ctxs: Sequence[int],
                   prefill_offsets: Optional[Sequence[int]] = None
                   ) -> StageCost:
        """Cost of ONE batch stage (= one scheduler iteration on one
        pipeline stage's share of layers) — a length-1 view over
        ``stage_cost_batch``."""
        batch = self.aggregate(prefill_lens, decode_ctxs, prefill_offsets)
        return self.stage_cost_batch(batch).row(0)

    def stage_cost_scalar(self, prefill_lens: Sequence[int],
                          decode_ctxs: Sequence[int],
                          prefill_offsets: Optional[Sequence[int]] = None):
        """One stage's cost without the length-1 array round-trip:
        ``aggregate`` + ``stage_cost_batch().row(0)`` spend most of
        their time wrapping four scalars into arrays and dispatching
        elementwise kernels over them — pure overhead on the event
        loop's hot path, where a day-scale exact epoch evaluates
        hundreds of thousands of single stages.

        Bit-identical to the batched path by construction: the batch-
        composition reductions keep numpy's pairwise summation (same
        expressions, ``.sum()`` method instead of the ``np.sum``
        wrapper), and the roofline runs the same IEEE-double operation
        sequence on Python floats. Pinned by tests.

        Returns ``(StageCost, prefill_tokens, decode_count,
        score_flops, kv_rw_bytes)`` — the cost plus the stage's
        StageBatch aggregates as plain floats (what the trace logs).
        """
        plens = np.asarray(prefill_lens, np.float64)
        ctxs = np.asarray(decode_ctxs, np.float64)
        offs = (np.zeros_like(plens) if prefill_offsets is None
                else np.asarray(prefill_offsets, np.float64))

        npt = float(plens.sum())
        nd = float(len(ctxs))
        avg_ctx = np.maximum(offs + np.floor(plens / 2.0), 1.0)
        f_score = (float((plens * self._score_per_token(avg_ctx)).sum())
                   + float(self._score_per_token(ctxs).sum()))
        kvpt = self.kv_bytes_per_token
        w = self.sliding_window
        kv_pre = (plens * kvpt + np.minimum(offs, w) * kvpt).sum()
        kv_dec = (np.minimum(ctxs, w) * kvpt + kvpt).sum()
        kv_rw = float(kv_pre + kv_dec)

        p = self._params
        tokens = npt + nd
        if tokens > 0:
            f_mlp = tokens * p.fpt_mlp
            f_attn = tokens * p.fpt_proj + f_score
            flops_st = (f_mlp + f_attn) / p.pp
            mem_st = (p.weight_bytes + kv_rw
                      + tokens * p.act_bytes_per_token) / p.pp
            eff = p.eff_max * tokens / (tokens + p.eff_half_tokens)
            t_comp = flops_st / (eff * p.peak_chips)
            t_mem = mem_st / p.hbm_chips
            t_coll = tokens * p.coll_s_per_token
            t = (max(t_comp, t_mem) + p.coll_scale * t_coll
                 + p.overhead_s)
            cost = StageCost(
                t_total=t, t_compute=t_comp, t_memory=t_mem,
                t_collective=t_coll, flops_mlp=f_mlp / p.pp,
                flops_attn=f_attn / p.pp,
                mfu=flops_st / (p.peak_chips * t))
        else:
            cost = StageCost(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        return cost, npt, nd, f_score, kv_rw


@functools.lru_cache(maxsize=512)
def cached_execution_model(model: ModelConfig, device_name: str,
                           tp: int, pp: int,
                           cfg: ExecModelConfig) -> ExecutionModel:
    """Per-process memoized ExecutionModel construction.

    ExecutionModel is stateless after __init__ (pure roofline
    functions over cached invariants), so sweep workers reuse one
    instance across every grid point that shares (model, device,
    TP, PP, exec config) instead of reconstructing it per scenario.
    """
    return ExecutionModel(model, DEVICES[device_name], tp, pp, cfg)


def calibrate_from_dryrun(exec_cfg: ExecModelConfig, hlo_dot_flops: float,
                          analytic_flops: float) -> ExecModelConfig:
    """Scale eff_max by the compiled-vs-analytic FLOP ratio so the
    simulator's time model reflects what XLA actually emits."""
    if analytic_flops <= 0 or hlo_dot_flops <= 0:
        return exec_cfg
    ratio = analytic_flops / hlo_dot_flops
    return dataclasses.replace(exec_cfg,
                               eff_max=exec_cfg.eff_max * min(1.0, ratio))
