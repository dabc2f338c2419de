"""Gather/scatter-free edge-data movement primitives.

These primitives move per-edge data with sorts, scans and n-sized scatters
instead of m-sized random gathers.  (Whether that beats a plain gather on
a GPU is an open measurement; see ROADMAP.md.)

* ``expand_to_edges``: broadcast per-vertex values to their (contiguous,
  sorted) edge segments via a bitcast-int32 boundary-delta + wrapping cumsum
  — EXACT for any 32-bit payload (two's-complement deltas telescope mod
  2^32, so even float bit patterns reconstruct bit-exactly).  This replaces
  gathers whose indices are the sorted segment ids.
* ``apply_fixed_perm``: apply a precomputed permutation (e.g. CSR->CSC edge
  order) with ONE ``lax.sort`` keyed by the static destination rank.
  Replaces gathers whose indices are an arbitrary-but-static permutation.

Random *dynamic* gathers never appear in the frontier engine: any per-edge
value is either keyed by the sorted axis (expansion) or carried across the
CSR<->CSC order switch (sort).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_to_edges(
    vertex_vals: jnp.ndarray,  # [n_pad, ...] any 32-bit dtype
    offsets: jnp.ndarray,  # int[n_pad+1] contiguous segment boundaries
    m_pad: int,
) -> jnp.ndarray:
    """out[e] = vertex_vals[seg(e)] where seg is the sorted segment id
    implied by ``offsets`` — no gather by edge indices.

    Mechanism: scatter per-vertex *deltas* (int32, wrapping) at segment
    starts, then cumsum.  The scatter is n-sized (cheap), the cumsum is
    vectorized.  Empty segments contribute coincident deltas which
    scatter-add combines correctly.

    Trailing dims (e.g. a head axis) batch through the same delta/cumsum,
    so K channels share one expansion.
    """
    dtype = vertex_vals.dtype
    bits = jax.lax.bitcast_convert_type(vertex_vals, jnp.int32)
    tail = bits.shape[1:]
    prev = jnp.concatenate([jnp.zeros((1,) + tail, jnp.int32), bits[:-1]])
    deltas = bits - prev  # wrapping int32 subtraction: exact mod 2^32
    starts = jnp.clip(offsets[:-1].astype(jnp.int32), 0, m_pad)
    buf = jnp.zeros((m_pad + 1,) + tail, jnp.int32)
    buf = buf.at[starts].add(deltas, mode="drop")
    out_bits = jnp.cumsum(buf[:m_pad], axis=0)
    return jax.lax.bitcast_convert_type(out_bits, dtype)


def apply_fixed_perm(
    rank: jnp.ndarray,  # int32[m]: output position of input element i
    *payloads: jnp.ndarray,
):
    """Return payloads permuted so output[rank[i]] = payload[i].

    Implemented as one multi-payload ``lax.sort`` on the static rank key.

    Float payloads route through a custom VJP (a permutation's transpose
    is its inverse permutation — one iota sort to build it, one sort to
    apply), so the reverse pass is a sort and not the m-sized scatter that
    native autodiff of ``lax.sort`` produces.  ``rank`` must be a true
    permutation of [0, m) — every production rank array (the csr/csc
    switch ranks over the padded domain) is.
    """
    if payloads and all(
        jnp.issubdtype(p.dtype, jnp.floating) for p in payloads
    ):
        outs = _apply_fixed_perm_diff(rank, tuple(payloads))
        return outs[0] if len(outs) == 1 else outs
    return _apply_fixed_perm_raw(rank, *payloads)


_sort_salt_counter = [0]


def _apply_fixed_perm_raw(rank, *payloads):
    # Per-call KEY SALT: XLA's algebraic simplifier may MERGE sorts that
    # share a key into one multi-operand sort; when one such sort's
    # output transitively feeds another (layer-chained CSR<->CSC switches
    # in a training graph), the merge can create a cyclic HLO that the
    # compiler rejects.  optimization_barrier on key or payloads does not
    # stop it (barriers are CSE'd/looked through).  Adding a distinct
    # small constant per traced call keeps the sort result bitwise
    # identical (a monotone shift of a permutation key) while making the
    # key VALUES unequal, so no two sorts are merge candidates.  Cost:
    # one [m] int vector add per sort.  The %64 window only needs to
    # separate sorts that could appear in ONE compiled program.
    salt = _sort_salt_counter[0] % 64
    _sort_salt_counter[0] += 1
    if salt:
        rank = rank + jnp.int32(salt)
    sorted_ = jax.lax.sort((rank,) + tuple(payloads), num_keys=1)
    outs = sorted_[1:]
    return outs[0] if len(outs) == 1 else outs


@jax.custom_vjp
def _apply_fixed_perm_diff(rank, payloads: tuple):
    out = _apply_fixed_perm_raw(rank, *payloads)
    return (out,) if len(payloads) == 1 else tuple(out)


def _apply_fixed_perm_fwd(rank, payloads):
    return _apply_fixed_perm_diff(rank, payloads), rank


def _apply_fixed_perm_bwd(rank, cts):
    import numpy as _np

    m = rank.shape[0]
    inv = _apply_fixed_perm_raw(
        rank, jnp.arange(m, dtype=jnp.int32)
    )  # inv[j] = i with rank[i] = j
    back = _apply_fixed_perm_raw(inv, *cts)
    if len(cts) == 1:
        back = (back,)
    zero_rank = _np.zeros(rank.shape, dtype=jax.dtypes.float0)
    return zero_rank, tuple(back)


_apply_fixed_perm_diff.defvjp(_apply_fixed_perm_fwd, _apply_fixed_perm_bwd)


def apply_fixed_perm_bit(
    rank2: jnp.ndarray,  # int32[m]: 2 * output position (precomputed)
    bits: jnp.ndarray,  # int32[m] in {0, 1}
) -> jnp.ndarray:
    """Permute a BIT array by packing it into the sort key: one
    single-array sort instead of key+payload.  ``rank2`` must be
    ``2 * rank`` (requires m < 2^30)."""
    packed = rank2 | bits
    return jax.lax.sort(packed) & 1


def segment_ends_take(
    edge_vals: jnp.ndarray,  # [m_pad, ...]
    offsets: jnp.ndarray,  # int[n+1]
    identity,
) -> jnp.ndarray:
    """out[v] = edge_vals[offsets[v+1]-1] for non-empty segments else
    identity — the final read-out of a segmented running reduce."""
    off = offsets.astype(jnp.int32)
    last = jnp.maximum(off[1:] - 1, 0)
    vals = edge_vals[last]
    nonempty = off[1:] > off[:-1]
    nonempty = nonempty.reshape(nonempty.shape + (1,) * (vals.ndim - 1))
    return jnp.where(nonempty, vals, identity)


def segmented_scan_reduce(
    vals: jnp.ndarray,  # [m_pad, ...] in sorted-segment order
    seg_ids: jnp.ndarray,  # int32[m_pad] sorted
    offsets: jnp.ndarray,  # int[n+1]
    op: str,  # 'min' | 'max' | 'sum'
    identity,
    max_seg_len: int | None = None,
) -> jnp.ndarray:
    """Segmented min/max/sum over contiguous sorted segments via a
    Hillis-Steele segmented scan (log2(max segment length) shifted-combine
    steps of plain vector ops), then a take at segment ends.  No scatter;
    deterministic.

    ``max_seg_len`` (static) bounds the scan depth — pass the graph's max
    degree to cut steps from log2(m) to log2(max_deg).

    Trailing dims batch: K channels (e.g. attention heads) share one set
    of scan steps, the segment-match mask broadcasting across lanes.
    """
    fn = {
        "min": jnp.minimum,
        "max": jnp.maximum,
        "sum": jnp.add,
        "bor": jnp.bitwise_or,  # bitwise OR: one scan reduces up to 32
        # independent boolean channels packed into an int32/uint32 lane
    }[op]
    m = vals.shape[0]
    if max_seg_len is None or max_seg_len > m:
        # a contiguous segment cannot exceed the stream itself; an
        # uncapped bound would shift by d >= m and break the concat shapes
        max_seg_len = m
    x = vals
    tail = vals.shape[1:]
    s = seg_ids
    d = 1
    while d < max_seg_len:
        pad_v = jnp.full((d,) + tail, identity, x.dtype)
        pad_s = jnp.full((d,), -1, s.dtype)
        sv = jnp.concatenate([pad_v, x[:-d]])
        ss = jnp.concatenate([pad_s, s[:-d]])
        match = (ss == s).reshape(s.shape + (1,) * len(tail))
        x = jnp.where(match, fn(x, sv), x)
        d *= 2
    return segment_ends_take(x, offsets, identity)
