"""A CPU mirror of the float32 decode kernel's design
(``decode_f32_kernel``, route ``bulk.fma``, in
``repro_torch/kernels/decode_attention/csrc/decode_attention.cu``).

The kernel cuts each (sequence, KV head)'s cache into the splits of
``ops.split_plan`` (one CTA each; splits past the valid slots exit), walks a
split in 32-slot tiles, tile j on consumer warp j % 3, and runs the online
softmax once per tile in log2 units: the tile's scores for every head, one
max per head, the rescale of the warp's row sum and accumulator, P V over
the tile's valid slots. The three warps' partials merge in warp order, the
splits' in split order (the last split to arrive combines them; a sequence
whose valid slots fit one split writes its output directly). This mirror
does the same in plain float32 torch and holds the result within 2e-5 of
the port's ``ref.py``, of the JAX package's ``decode_attention_reference``
(every case with a float32 cache, a subset with bf16) and of its Pallas
kernel in interpret mode (one head group per head dim, and the ring):
over head groups G of 1, 2, 3, 4 and 8 and head dims 16, 64, 80 and 128,
lengths 1, W and ragged (with splits wholly past a sequence's length), a
ring window with lengths past W, and float32 and bf16 caches. A property test holds the plan to covering each
sequence's valid slots exactly once, in whole tiles, whatever the batch.
What the mirror cannot show is the kernel's own FMA order and ``ex2.approx``;
``chip_smoke.py`` phase 3 and ``tests/test_torch_card.py`` hold the kernel
to the plain version on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_support import given, settings, st
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (
    decode_attention_reference as jax_decode_ref)
from repro_torch.kernels.decode_attention import decode_attention_reference
from repro_torch.kernels.decode_attention.ops import (MAX_SPLIT, MIN_CHUNK,
                                                      PASS, split_plan)

TILE = 32        # slots a tile: one a lane
CONSUMERS = 3    # consumer warps of a CTA: tile j goes to warp j % 3
TOL = dict(rtol=2e-5, atol=2e-5)
W, KV, SMS = 512, 2, 132   # four 128-slot splits of four tiles each
CACHES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_jax_ref = jax.jit(jax_decode_ref, static_argnames=("window",))


def _valid(lengths, W, window):
    n = lengths if window is None else np.minimum(lengths, window)
    return np.clip(n, 0, W)


def tiles(W, KV, sms, n_valid):
    """[(split, [(ts, rows), ...]), ...] the kernel walks for one (sequence,
    KV head) with ``n_valid`` valid slots: its non-empty splits and their
    tiles."""
    chunk, n_split = split_plan(W, KV, sms)
    out = []
    for split in range(n_split):
        t0 = split * chunk
        if t0 >= n_valid:
            continue
        t1 = min(t0 + chunk, n_valid)
        out.append((split, [(ts, min(TILE, t1 - ts)) for ts in range(t0, t1, TILE)]))
    return out


def _merge(parts):
    """Partials (m, l, acc) merged in order: the larger m, each rescaled to
    it, a part with l == 0 adding nothing."""
    live = [p for p in parts if float(p[1].max()) > 0]
    M = torch.stack([p[0] for p in live]).amax(0)
    L, A = torch.zeros_like(M), torch.zeros_like(live[0][2])
    for m, l, acc in live:
        f = torch.exp2(m - M)
        L = L + l * f
        A = A + acc * f[:, None]
    return M, L, A


def design_decode(q, k_cache, v_cache, lengths, *, window=None, sms=SMS):
    """The kernel's arithmetic in float32. Model layout: q (B, 1, H, D)
    float32; caches (B, W, KV, D) float32 or bf16; lengths (B,) int32."""
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale_log2 = torch.tensor(1.0 / math.sqrt(D) * math.log2(math.e),
                              dtype=torch.float32)
    n_valid = _valid(lengths.numpy(), W, window)
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        for kvh in range(KV):
            qg = q[b, 0, kvh * G:(kvh + 1) * G].float()           # (G, D)
            kb, vb = k_cache[b, :, kvh].float(), v_cache[b, :, kvh].float()
            splits = []
            for _, walk in tiles(W, KV, sms, int(n_valid[b])):
                warps = [(torch.full((G,), -math.inf), torch.zeros(G),
                          torch.zeros(G, D)) for _ in range(CONSUMERS)]
                for j, (ts, rows) in enumerate(walk):
                    m, l, acc = warps[j % CONSUMERS]
                    s = (qg @ kb[ts:ts + rows].T) * scale_log2    # (G, rows)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    warps[j % CONSUMERS] = (m_new, l * alpha + p.sum(-1),
                                            acc * alpha[:, None] + p @ vb[ts:ts + rows])
                splits.append(_merge(warps))
            if not splits:   # no valid slot: the kernel writes 0
                continue
            if len(splits) == 1:
                _, L, A = splits[0]
                o = A / L[:, None]
            else:
                _, L, A = _merge(splits)
                o = A / L[:, None]
            out[b, 0, kvh * G:(kvh + 1) * G] = o
    return out


def _inputs(seed, B, G, D, cache, W=W, amp=1.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, G * KV, D), dtype=np.float32)) * amp
    k, v = (torch.from_numpy(rng.standard_normal((B, W, KV, D), dtype=np.float32))
            .to(CACHES[cache]) for _ in range(2))
    return q, k, v


def _references(q, k, v, lengths, window=None, jax_ref=True, pallas=True):
    """The port's plain version and (optionally) the JAX reference and the
    JAX package's Pallas kernel in interpret mode, as float32 numpy."""
    B, _, H, D = q.shape
    G = H // KV
    tr = lambda x: x.transpose(1, 2)
    port = decode_attention_reference(q.reshape(B, KV, G, D), tr(k), tr(v),
                                      lengths, window=window).reshape(B, 1, H, D)
    jq = jnp.asarray(q.numpy())
    jk = jnp.asarray(k.float().numpy(), jnp.bfloat16 if k.dtype == torch.bfloat16
                     else jnp.float32)
    jv = jnp.asarray(v.float().numpy(), jk.dtype)
    jl = jnp.asarray(lengths.numpy())
    out = {"port ref.py": port.numpy()}
    if jax_ref:
        out["jax reference"] = np.asarray(_jax_ref(
            jq.reshape(B, KV, G, D), jk.transpose(0, 2, 1, 3),
            jv.transpose(0, 2, 1, 3), jl, window=window),
            np.float32).reshape(B, 1, H, D)
    if pallas:
        out["pallas"] = np.asarray(jax_decode(jq, jk, jv, jl, window=window,
                                              interpret=True), np.float32)
    return out


# The port's ref.py everywhere; the JAX reference (a compile per shape)
# everywhere with a float32 cache, and with a bf16 cache on one head group
# per head dim and the served widths, where Pallas (interpret mode) runs
# too with a float32 cache
PALLAS = {(3, 16), (8, 64), (2, 80), (4, 128), (1, 128)}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_design_matches_references(G, D, cache):
    """Lengths 1 (three splits past it), W (four splits of four tiles: the
    warps take 2, 1, 1 tiles each), 200 and 300 (ragged, splits past them),
    q x4 so that the splits' maxima differ."""
    q, k, v = _inputs(G * 100 + D, 4, G, D, cache, amp=4.0)
    lengths = torch.tensor([1, W, 200, 300], dtype=torch.int32)
    got = design_decode(q, k, v, lengths).numpy()
    refs = _references(q, k, v, lengths,
                       jax_ref=cache == "float32" or (G, D) in PALLAS,
                       pallas=cache == "float32" and (G, D) in PALLAS)
    for name, want in refs.items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("cache", list(CACHES))
def test_design_ring_window_past_W(cache):
    """A ring of W slots (window = W) with lengths past W: every slot valid
    once the ring has wrapped, as in the JAX package's kernel."""
    q, k, v = _inputs(7, 3, 4, 64, cache)
    lengths = torch.tensor([W + 57, 3 * W, 100], dtype=torch.int32)
    got = design_decode(q, k, v, lengths, window=W).numpy()
    for name, want in _references(q, k, v, lengths, window=W).items():
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_design_sequence_alone_equals_it_in_a_batch():
    """The plan ignores B and no split reads another sequence: a sequence
    decoded alone gives, bit for bit, its row of the batch of 8."""
    q, k, v = _inputs(11, 8, 4, 128, "float32")
    lengths = torch.tensor([513, 1, 1, 1, 2 * TILE + 3, 1, 1, W], dtype=torch.int32)
    full = design_decode(q, k, v, lengths)
    for b in (0, 4, 7):
        one = design_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1])
        assert torch.equal(one, full[b:b + 1])


def test_splits_past_the_length_hold_no_tile():
    """A one-slot sequence at W = 512 has one non-empty split of one tile;
    the plan's other three splits exit without a tile."""
    assert split_plan(W, KV, SMS) == (128, 4)
    assert tiles(W, KV, SMS, 1) == [(0, [(0, 1)])]
    assert [s for s, _ in tiles(W, KV, SMS, 300)] == [0, 1, 2]


@settings(max_examples=150, deadline=None)
@given(W=st.integers(1, 20000), KV=st.sampled_from([1, 2, 4, 8]),
       sms=st.integers(1, 264), data=st.data())
def test_plan_covers_the_cache_exactly_once(W, KV, sms, data):
    """For any W, KV and SM count, the plan's splits cover the cache with
    whole tiles, within MAX_SPLIT splits of at least MIN_CHUNK slots, and
    the tiles of any valid length cover slots 0 .. n - 1 exactly once; the
    plan takes no batch, so each sequence's tiles are those it would have
    alone."""
    chunk, n_split = split_plan(W, KV, sms)
    assert chunk % PASS == 0 and chunk % TILE == 0 and chunk >= MIN_CHUNK
    assert 1 <= n_split <= MAX_SPLIT and (n_split - 1) * chunk < W <= n_split * chunk
    n = data.draw(st.integers(0, W))
    walked = [t for _, walk in tiles(W, KV, sms, n)
              for ts, rows in walk for t in range(ts, ts + rows)]
    assert walked == list(range(n))
    assert all(rows >= 1 for _, walk in tiles(W, KV, sms, n) for _, rows in walk)
