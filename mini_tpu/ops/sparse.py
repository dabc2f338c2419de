"""Sparse (compact-frontier) advance: bounded-shape frontier expansion.

The dense engine sweeps all m edges per iteration — right for large
frontiers, wasteful for tiny ones (high-diameter graphs pay diameter x m).
This re-expresses the reference's load-balanced sparse
advance (`/root/reference/gunrock/src/advance.hxx:21-67`): the degree scan +
``transform_lbs`` merge-path search becomes an exclusive cumsum + a
vectorized ``searchsorted`` over a *static-capacity* edge slot array, so the
whole expansion stays jit-compatible.  Work is O(capacity), not O(m):
per-element XLA gathers are affordable here because the frontier is small by
construction (the direction switch guarantees fit before selecting this
path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mini_tpu.graph.csr import GraphSlice
from mini_tpu.ops.segment import exclusive_cumsum


def default_tiers(
    g: GraphSlice,
    max_capv: int | None = None,
    max_cape: int | None = None,
) -> list[tuple[int, int]]:
    """Ascending (capv, cape) capacity tiers for the sparse path.

    Static shapes mean a sparse step costs O(capacity) regardless of the
    actual frontier, so several tiers let tiny frontiers (high-diameter
    graphs) pay tiny sweeps while mid-size frontiers still beat the dense
    O(m) sweep.  Tiers top out around m/16 — beyond that the dense engine
    wins (a sparse step pays random gathers per element, the dense sweep
    streams).
    """
    if max_cape is None:
        max_cape = max(2048, g.m_pad // 64)
    if max_capv is None:
        max_capv = min(g.n_pad, max_cape)
    # ONE sparse tier: every extra lax.switch branch is a separately
    # compiled loop body, and its compile time outweighs the runtime
    # difference between tier sizes
    cape = min(max_cape, g.m_pad)
    return [(min(max_capv, cape, g.n_pad), cape)]


def frontier_edge_count(g: GraphSlice, mask: jnp.ndarray) -> jnp.ndarray:
    """Total out-edges of frontier vertices (the reference's degree-scan
    total, kept on device)."""
    return jnp.sum(jnp.where(mask, g.out_degrees, 0), dtype=jnp.int32)


def compact_frontier(mask: jnp.ndarray, capv: int):
    """Bounded compaction of a bitmap (see ops/frontier.compact_mask, but
    zero-filling instead of -1 holes so downstream gathers stay
    in-bounds).  Returns (indices int32[capv] ascending, count,
    overflowed).  ``overflowed`` is True when the population exceeded
    ``capv`` and entries were dropped; the algorithms' tier selection
    checks capacity-fit BEFORE routing here (``frontier_edge_count``), so
    on those paths the flag is statically False — direct callers must
    check it (the reference hard-exits instead, `frontier.hxx:85-93`).

    Mechanism: ``lax.top_k`` over position-coded mask values — the k
    largest values ARE the k smallest set positions (in place of a
    cumsum + n-sized scatter)."""
    n = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    vals = jnp.where(
        mask, jnp.int32(n) - jnp.arange(n, dtype=jnp.int32), jnp.int32(0)
    )
    top, _ = jax.lax.top_k(vals, capv)
    idx = jnp.where(top > 0, jnp.int32(n) - top, 0)
    return idx, jnp.minimum(count, capv), count > capv


def relax_and_chain(
    g: GraphSlice,
    dist: jnp.ndarray,  # float32[n_pad]
    weights: jnp.ndarray,  # float32[m_pad] CSR-ordered edge weights
    idx: jnp.ndarray,  # int32[capv] compact frontier (deduped, real ids)
    cnt: jnp.ndarray,  # int32
    cape: int,  # expansion capacity (caller guarantees fit)
    capv_next: int,  # capacity of the derived next frontier
    bound=None,  # optional f32 scalar: chain only dsts with d2 < bound
):
    """One fused sparse SSSP round: expand+relax the compact frontier
    AND derive the next compact frontier from the same cape-sized
    arrays — indices->indices, no bitmap round-trip ("compact
    chaining").

    A bitmap sparse round pays O(n) for the bitmap ``top_k`` and the
    fe/fl scans; chaining replaces them with O(cape) work.  The chained
    round itself is gather-bound, so this fused form keeps the
    big-table random accesses to the essential four — ``csr_dsts``
    and ``weights`` at eid, ``dist`` at src, ``dist`` at the deduped
    dsts: row offsets/degrees broadcast from the capv-sized frontier
    table, and the improved-dst detection rides a TWO-KEY sort
    ``(dst, cand)`` whose per-dst head is the relax minimum (no
    ``d2[edst]``/``dist[edst]`` gathers at all).

    Returns ``(d2, sdst, imp_first, next_idx, next_cnt, next_fe,
    next_ok, ovf)``:

    * ``d2`` — post-relax distances (bitwise equal to the scatter-min
      of all candidates; f32 min is exact and order-independent);
    * ``sdst``/``imp_first`` — cape-sized sorted dst array + mask of
      each improved dst's first slot (for bounded pending updates);
    * ``next_*`` — the chained frontier: deduped improved dsts (with
      ``d2 < bound`` when given), its size, its total out-degree, and
      whether it is usable (non-empty and nothing dropped — on
      overflow callers fall back to the bitmap path; the frontier is
      never silently truncated);
    * ``ovf`` — expansion overflow (must stay False under the caller's
      capacity-fit selection).
    """
    n_pad = g.n_pad
    m_pad = g.m_pad
    capv = idx.shape[0]
    inf = jnp.float32(jnp.inf)
    k = min(capv_next, cape)

    in_range = jnp.arange(capv) < cnt
    idxs = jnp.where(in_range, idx, 0)
    ro = g.row_offsets[idxs].astype(jnp.int32)  # capv-sized gathers
    degs = jnp.where(in_range, g.out_degrees[idxs], 0)
    pos = exclusive_cumsum(degs)
    total = pos[-1] + degs[-1]

    # merge-path assignment (cf. expand_frontier): scatter a +1 at each
    # vertex's start offset and prefix-sum
    starts = jnp.where(in_range, jnp.clip(pos, 0, cape), cape)
    hist = jnp.zeros(cape + 1, jnp.int32).at[starts].add(1, mode="drop")
    vslot = jnp.cumsum(hist[:cape]) - 1
    vslot = jnp.clip(vslot, 0, capv - 1)

    slots = jnp.arange(cape, dtype=jnp.int32)
    # src/offset/degree all come from the capv-sized tables via vslot
    # (small-table gathers are ~2x cheaper than n-sized ones)
    src = idxs[vslot]
    rank = slots - pos[vslot]
    eid = jnp.clip(ro[vslot] + rank, 0, m_pad - 1)
    valid = (slots < total) & (rank >= 0) & (rank < degs[vslot])
    dst = g.csr_dsts[eid]  # essential big-table gathers: dst, w, dist
    cand = dist[src] + weights[eid]

    dstw = jnp.where(valid, dst, n_pad)
    d2 = (
        jnp.concatenate([dist, jnp.full(1, inf)])
        .at[dstw]
        .min(jnp.where(valid, cand, inf), mode="drop")[:n_pad]
    )

    # two-key sort: per-dst relax minimum arrives at each dst's first
    # slot; invalid slots sink to the tail
    sdst, scand = jax.lax.sort(
        (dstw, jnp.where(valid, cand, inf)), num_keys=2
    )
    prev = jnp.concatenate([jnp.full(1, -1, sdst.dtype), sdst[:-1]])
    first = (sdst != prev) & (sdst < n_pad)
    dold = dist[jnp.where(first, sdst, 0)]
    imp_first = first & (scand < dold)
    keep = imp_first
    if bound is not None:
        keep = keep & (jnp.minimum(scand, dold) < bound)

    vals = jnp.where(
        keep, jnp.int32(cape) - slots, jnp.int32(0)
    )
    top, _ = jax.lax.top_k(vals, k)
    tpos = jnp.where(top > 0, jnp.int32(cape) - top, 0)
    nidx = jnp.where(top > 0, sdst[tpos], 0)
    if k < capv_next:
        nidx = jnp.concatenate(
            [nidx, jnp.zeros(capv_next - k, jnp.int32)]
        )
    ncnt = jnp.sum(keep.astype(jnp.int32))
    ndegs = jnp.where(
        jnp.arange(capv_next) < jnp.minimum(ncnt, k),
        g.out_degrees[nidx], 0,
    )
    nfe = jnp.sum(ndegs, dtype=jnp.int32)
    nok = (ncnt <= k) & (ncnt > 0)
    return (
        d2, sdst, imp_first, nidx, jnp.minimum(ncnt, k), nfe, nok,
        total > cape,
    )


def default_chain_cap(g: GraphSlice, sparse_cape: int) -> int:
    """Capacity of the chained reentry rounds (round 5).

    Chained rounds cost O(chain_cap) in every term (the 2-key sort,
    top_k, the essential big-table gathers, the bounded scatters), so
    smaller is faster — but a chain whose frontier outgrows it falls
    back to an O(n)-floor bitmap round.  Light-edge reentry frontiers
    on the target family (grids, meshes) are far smaller than the
    bitmap tier's m/64; the default sits a factor 4 below it, floored
    at 4096 to amortize fixed per-op overheads."""
    return int(min(sparse_cape, max(4096, g.m_pad // 256)))


def visit_and_chain(
    g: GraphSlice,
    labels: jnp.ndarray,  # int32[n_pad], -1 = unvisited
    idx: jnp.ndarray,  # int32[capv] compact frontier (deduped, real ids)
    cnt: jnp.ndarray,  # int32
    cape: int,  # expansion capacity (caller guarantees fit)
    capv_next: int,  # capacity of the derived next frontier
    new_label,  # int32 scalar: depth stamp for newly visited dsts
):
    """One fused sparse BFS round: visit the compact frontier's
    unvisited out-neighbours AND derive the next compact frontier from
    the same cape-sized arrays (the BFS twin of :func:`relax_and_chain`
    — no bitmap round-trip, no O(n) work at all).

    Returns ``(labels2, next_idx, next_cnt, next_fe, next_ok, ovf)``;
    ``next_ok`` is False when the round discovered nothing or the next
    frontier overflows ``capv_next`` (callers fall back to the bitmap
    path — the frontier is never silently truncated).
    """
    n_pad = g.n_pad
    m_pad = g.m_pad
    capv = idx.shape[0]
    k = min(capv_next, cape)

    in_range = jnp.arange(capv) < cnt
    idxs = jnp.where(in_range, idx, 0)
    ro = g.row_offsets[idxs].astype(jnp.int32)
    degs = jnp.where(in_range, g.out_degrees[idxs], 0)
    pos = exclusive_cumsum(degs)
    total = pos[-1] + degs[-1]

    starts = jnp.where(in_range, jnp.clip(pos, 0, cape), cape)
    hist = jnp.zeros(cape + 1, jnp.int32).at[starts].add(1, mode="drop")
    vslot = jnp.cumsum(hist[:cape]) - 1
    vslot = jnp.clip(vslot, 0, capv - 1)

    slots = jnp.arange(cape, dtype=jnp.int32)
    rank = slots - pos[vslot]
    eid = jnp.clip(ro[vslot] + rank, 0, m_pad - 1)
    valid = (slots < total) & (rank >= 0) & (rank < degs[vslot])
    dst = g.csr_dsts[eid]  # the essential big-table gathers: dst, label
    sel = valid & (labels[dst] == -1)

    dstw = jnp.where(sel, dst, jnp.int32(n_pad))
    labels2 = labels.at[dstw].set(
        jnp.int32(new_label), mode="drop"
    )  # duplicate dsts all write the same stamp

    sdst = jax.lax.sort(dstw)
    prev = jnp.concatenate([jnp.full(1, -1, sdst.dtype), sdst[:-1]])
    first = (sdst != prev) & (sdst < n_pad)
    vals = jnp.where(first, jnp.int32(cape) - slots, jnp.int32(0))
    top, _ = jax.lax.top_k(vals, k)
    tpos = jnp.where(top > 0, jnp.int32(cape) - top, 0)
    nidx = jnp.where(top > 0, sdst[tpos], 0)
    if k < capv_next:
        nidx = jnp.concatenate(
            [nidx, jnp.zeros(capv_next - k, jnp.int32)]
        )
    ncnt = jnp.sum(first.astype(jnp.int32))
    ndegs = jnp.where(
        jnp.arange(capv_next) < jnp.minimum(ncnt, k),
        g.out_degrees[nidx], 0,
    )
    nfe = jnp.sum(ndegs, dtype=jnp.int32)
    nok = (ncnt <= k) & (ncnt > 0)
    return labels2, nidx, jnp.minimum(ncnt, k), nfe, nok, total > cape


def expand_frontier(
    g: GraphSlice,
    indices: jnp.ndarray,  # int32[capv]
    count: jnp.ndarray,  # int32
    cape: int,
):
    """Expand the compact frontier into up to ``cape`` edge slots.

    Returns (src, dst, eid, valid) arrays of shape [cape].  Edge slots past
    the total work count are invalid.  Caller must guarantee
    ``frontier_edge_count <= cape`` (the direction switch does).
    """
    capv = indices.shape[0]
    in_range = jnp.arange(capv) < count
    idx = jnp.where(in_range, indices, 0)
    degs = jnp.where(in_range, g.out_degrees[idx], 0)
    pos = exclusive_cumsum(degs)  # [capv]
    total = pos[-1] + degs[-1]

    # merge-path assignment without searchsorted (whose binary search costs
    # log(capv) cape-sized gathers): scatter a +1 at each vertex's start
    # offset and prefix-sum — vslot[s] = (# starts <= s) - 1.  Zero-degree
    # frontier vertices stack at the same bin; the later vertex wins, which
    # matches searchsorted(side='right')-1.
    starts = jnp.where(in_range, jnp.clip(pos, 0, cape), cape)
    hist = jnp.zeros(cape + 1, jnp.int32).at[starts].add(1, mode="drop")
    vslot = jnp.cumsum(hist[:cape]) - 1
    vslot = jnp.clip(vslot, 0, capv - 1)

    slots = jnp.arange(cape, dtype=jnp.int32)
    valid = slots < total
    src = indices[vslot]
    rank = slots - pos[vslot]
    eid = g.row_offsets[src] + rank
    eid = jnp.clip(eid, 0, g.m_pad - 1)
    dst = g.csr_dsts[eid]
    valid = valid & (rank < g.out_degrees[src]) & (rank >= 0)
    return src, dst, eid, valid, total
