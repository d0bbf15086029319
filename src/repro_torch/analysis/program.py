"""Per-rank accounting of a traced torch program: dot FLOPs, an HBM-traffic
proxy, collective bytes, peak live bytes.

Counterpart of ``repro.analysis.hlo``, which parses XLA's post-SPMD HLO text.
The port has no HLO: ``trace_program`` runs the program once, abstractly, on
fake tensors (``FakeTensorMode``) inside a fake process group, under one
``TorchDispatchMode`` (``ProgramCounter``) and no module hooks, and prices
every operation as it is dispatched. Loops need no trip counts: an eager
trace runs every layer, microbatch and chunk, so each is counted as often as
it runs (the reference multiplies a ``while`` body by its trip count).

Every quantity is **this rank's local work**. A ``DTensor`` operation reaches
the counter with its global shapes; the counter lets ``DTensor`` handle it
(``NotImplemented``) and prices the operations on the local shards it then
issues: the local product, and the functional collectives its redistribution
sends. The sharding propagator also runs each new operation once on fake
tensors of the global shapes, only to learn its output's metadata; it enters
the program's fake mode to do so (``detect_fake_mode``), and the counter
ignores what runs while that mode is entered a second time (``TraceMode``).

- ``dot_flops``: the operations of ``torch.utils.flop_counter``'s registry
  (matmuls, attention, convolutions), by its formulas; ``dot_count`` counts
  them. An operation outside the registry that decomposes is priced by its
  decomposition, as ``FlopCounterMode`` does.
- ``hbm_bytes``: the bytes each operation reads (its tensor arguments) and
  writes (its outputs), views and allocations excepted: eager torch runs
  every operation as its own kernel, so no fusion hides an intermediate.
  Like ``hlo.py``'s 2 x result bytes, a proxy of the traffic, not a reading.
- collectives: each functional collective's result bytes, by kind, counted
  at the collective (its ``wait_tensor`` is not), with ``hlo.py``'s ring
  factors for ``link_bytes``.
- peak live bytes: the most bytes held at once by the tensors the program
  allocated (each counted from its creation until it is freed), its
  arguments not included.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op name -> the reference's HLO kind
_COLLECTIVE_OPS = (("all_gather", "all-gather"),
                   ("reduce_scatter", "reduce-scatter"),
                   ("all_reduce", "all-reduce"),
                   ("all_to_all", "all-to-all"),
                   ("permute", "collective-permute"))

# elementwise transcendental functions, counted per output element
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
    "rsqrt", "sqrt", "sin", "cos", "erf", "pow", "softplus", "silu", "gelu",
    "_softmax", "_log_softmax", "logsumexp"))

# operations that move no bytes of their own
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "wait_tensor",
                         "is_same_size", "sym_size", "sym_stride", "sym_numel",
                         "sym_storage_offset"))
_DEVICE = torch.ops.prim.device.default


class TraceMode(FakeTensorMode):
    """The fake mode of a traced program. It records how deeply it is
    entered: the program runs inside it once; the sharding propagator's
    metadata runs enter it again."""

    depth = 0

    def __enter__(self):
        self.depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self.depth -= 1
        return super().__exit__(*exc)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Trace:
    """What ``ProgramCounter`` counted over one run."""
    dot_flops: float = 0.0
    dot_count: int = 0
    hbm_bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_count: int = 0
    ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0


class ProgramCounter(TorchDispatchMode):
    """Prices every operation dispatched on this rank's local tensors into
    ``self.trace`` (see the module docstring)."""

    def __init__(self, fake_mode: TraceMode):
        super().__init__()
        self.fake_mode = fake_mode
        self.trace = Trace()
        self._whole = set()      # operations that do not decompose

    def _free(self, n: int):
        self.trace.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # priced at the local ops it issues
        if self.fake_mode.depth > 1 or func is _DEVICE:
            # the sharding propagator's metadata runs; a tensor's device
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func not in self._whole:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            self._whole.add(func)
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out):
        tr = self.trace
        name = packet.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        tr.ops += 1
        if packet in flop_registry:
            tr.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
            tr.dot_count += 1
        if name in _TRANSCENDENTAL:
            tr.transcendentals += sum(t.numel() for t in outs)
        if func.namespace.startswith("_c10d_functional"):
            kind = next((k for op, k in _COLLECTIVE_OPS if op in name), None)
            if kind is not None:
                tr.collectives[kind] += sum(_nbytes(t) for t in outs)
                tr.collective_count += 1
        if func.is_view or name in _NO_TRAFFIC or not outs:
            new = [] if func.is_view else outs
        else:
            tr.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            new = outs
        # allocations: outputs that are neither views nor an argument
        seen = {id(t) for t in ins}
        for t in new:
            if id(t) in seen or t._is_view():
                continue
            n = _nbytes(t)
            tr.live_bytes += n
            tr.peak_bytes = max(tr.peak_bytes, tr.live_bytes)
            weakref.finalize(t, self._free, n)


def trace_program(fn: Callable, *args, fake_mode: TraceMode):
    """Runs ``fn(*args)`` once under ``fake_mode`` (whose tensors ``args``
    hold) and a ``ProgramCounter``. Returns (its outputs, the ``Trace``)."""
    counter = ProgramCounter(fake_mode)
    with fake_mode, counter:
        out = fn(*args)
    return out, counter.trace


def collective_bytes(trace: Trace) -> Dict[str, float]:
    """The reference's collective record: result bytes per kind, ``count``,
    ``total`` and ``link_bytes`` (ring all-reduce 2x, the others 1x)."""
    total: Dict[str, float] = dict(trace.collectives)
    total["count"] = trace.collective_count
    total["total"] = sum(trace.collectives[k] for k in COLLECTIVES)
    total["link_bytes"] = (2.0 * total["all-reduce"] + total["all-gather"]
                           + total["reduce-scatter"] + total["all-to-all"]
                           + total["collective-permute"])
    return total


def program_stats(trace: Trace) -> Dict[str, float]:
    """{dot_flops, hbm_bytes, dot_count} of the whole program on this rank."""
    return {"dot_flops": float(trace.dot_flops),
            "hbm_bytes": float(trace.hbm_bytes),
            "dot_count": float(trace.dot_count)}
