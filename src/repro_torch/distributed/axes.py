"""Logical-axis sharding environment.

Counterpart of ``repro.distributed.axes``. Model code is mesh-agnostic: it
annotates intermediates with *logical* axis names via ``constrain(x,
("batch", "seq", "embed"))``. The launcher activates an environment mapping
logical names to physical mesh axes (e.g. batch -> ("pod", "data"),
heads/mlp/expert -> "model"). Outside an active environment, or on a plain
tensor, ``constrain`` is a no-op, so the same model code runs on one device
and across ranks.

The reference's program is one SPMD trace that XLA partitions; the port runs
one process per device, its tensors ``DTensor``s on a ``DeviceMesh`` whose
dimension names are the physical axes. A spec becomes DTensor placements by
``placements``: ``Shard(d)`` on every mesh dimension that names tensor
dimension ``d``, ``Replicate()`` elsewhere. ``on_local`` runs a function
that cannot take a ``DTensor`` (a hand-written kernel, an op without a
sharding rule) on each rank's shard.
"""
from __future__ import annotations

import contextlib
import types
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# process-wide, not per thread: autograd runs a CUDA backward (and remat's
# recomputation in it) on a device thread of its own, which must see the
# same mapping as the forward
_state = types.SimpleNamespace(env=None)

AxisName = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """A tuple of per-dimension mesh axes (None, a name, or a tuple of
    names), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: AxisName):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a dict (the planning functions read only
    this)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _current() -> Optional[dict]:
    return _state.env


@contextlib.contextmanager
def axis_env(mesh, mapping: Dict[str, AxisName]):
    """Activate a logical->physical axis mapping for the enclosed code."""
    prev = _current()
    _state.env = {"mesh": mesh, "map": dict(mapping)}
    try:
        yield
    finally:
        _state.env = prev


def logical_to_spec(axes: Tuple[Optional[str], ...],
                    mapping: Dict[str, AxisName]) -> PartitionSpec:
    phys = []
    used = set()
    for a in axes:
        m = mapping.get(a) if a is not None else None
        # a physical axis may appear at most once in a PartitionSpec
        if m is not None:
            flat = (m,) if isinstance(m, str) else tuple(m)
            flat = tuple(f for f in flat if f not in used)
            used.update(flat)
            m = flat if len(flat) > 1 else (flat[0] if flat else None)
        phys.append(m)
    return PartitionSpec(*phys)


def placements(spec: Sequence[AxisName], mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d`` names, ``Replicate()`` on the
    others. A tuple entry shards its dimension over its axes in mesh order
    (the major axis first), as a multi-axis entry of a PartitionSpec. A mesh
    dimension of one rank replicates: its one shard is the whole."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(axis)
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def constrain(x, axes: Tuple[Optional[str], ...]):
    """Redistribute a ``DTensor`` to the placements of the logical spec
    ``axes`` if an axis env is active; anything else passes through."""
    env = _current()
    if env is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, env["map"])
    return x.redistribute(env["mesh"], placements(spec, env["mesh"]))


def add_to_stream(x, y):
    """``x + y`` for the residual stream ``x`` (batch, seq, embed) and a
    block's output ``y``: inside an axis env ``y`` first takes the stream's
    layout, so the add's backward hands the block a gradient in the block's
    own layout (under sequence parallelism the stream is split along batch
    and sequence at once, which the block's last product cannot flatten)."""
    return x + constrain(y, ("batch", "seq", "embed"))


def _sharded(p, dims: Sequence[int]) -> bool:
    return isinstance(p, Shard) and p.dim in dims


def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, n = [], 1
    for s in reversed(shape):
        strides.append(n)
        n *= s
    return tuple(reversed(strides))


def on_local(fn: Callable, *args, keep: Sequence[int] = (0,),
             whole: Sequence[int] = ()):
    """``fn(*args)`` on each rank's shard when the tensor arguments are
    ``DTensor``s, else ``fn(*args)`` as it is.

    The first ``DTensor`` argument keeps its shards along its dimensions in
    ``keep`` (by default the batch) and is gathered along the others; every
    other ``DTensor`` argument is split alike along the same dimensions,
    except where it broadcasts (size 1), and is gathered elsewhere; the
    arguments at positions ``whole`` (weights) are gathered whole. ``fn``
    then sees the local tensors, must treat the kept dimensions slice by
    slice, and returns a tensor or a tuple of tensors laid out like the
    first argument on those dimensions; each output becomes a ``DTensor``
    with its placements. Gradients flow through the pair (``to_local`` /
    ``from_local``): a split argument's local gradient is its shard of the
    whole, a broadcast one's a partial sum over the ranks that split the
    work."""
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    target = [Shard(p.dim) if _sharded(p, keep) else Replicate()
              for p in first.placements]

    def laid_out(a):
        return [p if isinstance(p, Replicate) or a.shape[p.dim] > 1
                else Replicate() for p in target]
    local = []
    for n, a in enumerate(args):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        pl = [Replicate()] * len(target) if n in whole else laid_out(a)
        grad = [p if isinstance(p, Shard) else
                Partial() if isinstance(t, Shard) else Replicate()
                for p, t in zip(pl, target)]
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=grad))
    out = fn(*local)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = list(t.shape)
        for p in target:
            if isinstance(p, Shard):   # shards may be uneven (3 heads over 2)
                shape[p.dim] = first.shape[p.dim]
        return DTensor.from_local(t.contiguous(), mesh, target, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))
    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def split_over(w, dims: Sequence[int]) -> bool:
    """Whether ``w`` is a ``DTensor`` split (over a mesh dimension of more
    than one rank) along any of tensor dimensions ``dims``."""
    return isinstance(w, DTensor) and any(
        isinstance(p, Shard) and p.dim in dims and n > 1
        for p, n in zip(w.placements, w.device_mesh.shape))


def whole_along(x, dims: Sequence[int]):
    """A ``DTensor`` gathered along tensor dimensions ``dims`` (its other
    splits kept); anything else as it is."""
    if not split_over(x, dims):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if _sharded(p, dims) else p for p in x.placements])


def contract_whole(product: Callable, x, w, dims: Sequence[int] = (0,)):
    """``product(x, w)`` in x's dtype, for a product that contracts ``w``'s
    dimensions ``dims`` with x's last ones. When those are split over ranks
    (a row-parallel product under tensor parallelism), w's split dimensions
    and every dimension of x but its batch and sequence (0, 1) are gathered
    first, so each rank sums whole rows as the unsharded product does and
    rounds as it does: a sum of bf16 partial products, one per rank, would
    round each partial and the sum apart."""
    w = w.to(x.dtype)
    if split_over(w, dims):
        w = whole_along(w, dims)
        x = whole_along(x, range(2, x.ndim))
    return product(x, w)


def for_compute(x):
    """A parameter as the forward uses it: inside an axis env, a
    ``DTensor``'s shards over the batch axes are gathered (FSDP keeps them
    only for storage; in the ``dp`` variant the batch takes every axis, so
    the whole parameter is gathered). Anything else passes through."""
    env = _current()
    if env is None or not isinstance(x, DTensor):
        return x
    batch = env["map"].get("batch") or ()
    batch = (batch,) if isinstance(batch, str) else tuple(batch)
    mesh = x.device_mesh
    pl = [Replicate() if name in batch else p
          for name, p in zip(mesh.mesh_dim_names, x.placements)]
    return x.redistribute(mesh, pl)


def like(g, p):
    """``g`` (a gradient) in the placements of ``p`` (its parameter): a
    partial sum is reduced, a replicated one sharded."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def to_plain(x):
    """The whole tensor of a ``DTensor`` (gathered on every rank; a
    collective), anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# Default logical-axis mapping for the production meshes.
def default_mapping(multi_pod: bool = False) -> Dict[str, AxisName]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,           # sequence usually unsharded (SP for long_500k)
        "embed": None,
        "heads": "model",
        "head_dim": None,
        "kv_heads": None,      # replicated when they don't divide TP
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "capacity": batch,
        "layers": None,
    }
