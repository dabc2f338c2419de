"""k-core decomposition by iterative peeling.

Reference recipe (`/root/reference/gunrock/src/kcore/kcore_enactor.hxx:41-84`):
for k = 1..n, repeatedly filter out vertices with ``0 < degree < k``
(recording core number k-1 and zeroing their degree), then advance over the
removed set decrementing each out-neighbor's degree with atomicAdd
(`kcore/kcore_functor.hxx:31-35`); when no vertex with degree >= k survives,
the largest k-core is k-1.

Design: degrees/cores are dense arrays; the degree decrement is a
segment-sum of removed-source edge counts (deterministic, replacing
atomicAdd); both the peel loop and the outer k loop are on-device
``lax.while_loop``s — zero host round-trips.  Degrees carry over between k
values exactly as the reference's persistent ``d_degrees`` does.

Two variants:

* ``variant="mini"`` — the reference peeling recipe above, bitwise-matched
  by ``kcore_cpu``.  Note its multigraph artifact (inherited semantics): a
  vertex whose degree is driven to <= 0 purely by parallel-edge decrements
  is never peeled (the peel predicate requires ``deg > 0``,
  `kcore/kcore_functor.hxx:13`), so it keeps core 0.
* ``variant="hindex"`` (undirected graphs; the ``"auto"`` default picks it)
  — true core numbers via the h-index fixpoint iteration (Lu et al. 2016):
  h_0 = degree, h_{t+1}(v) = H({h_t(u) : u ~ v}), converging to coreness.
  Iteration-count wins are dramatic on power-law graphs: RMAT scale 16
  needs 33 h-iterations vs 500+ peel rounds.  Each iteration is one
  expansion (h[src] per CSR edge) + one sort grouping values by dst in
  descending order + one prefix-sum-difference count of positions with
  value >= within-segment rank.  Validated against ``kcore_cpu_true``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.engine import reduce_csc_by_dst
from mini_tpu.ops.permute import expand_to_edges, apply_fixed_perm_bit
from mini_tpu.ops.segment import contiguous_segment_sum
from mini_tpu.ops.sparse import (
    compact_frontier,
    expand_frontier,
    frontier_edge_count,
    default_tiers,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KCoreResult:
    num_cores: jnp.ndarray  # int32[n_pad]: core number per vertex
    largest_k_core: jnp.ndarray  # int32
    num_iterations: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(1,))
def _kcore_impl(g: GraphSlice, max_k: int):
    n_pad = g.n_pad

    deg0 = g.out_degrees.astype(jnp.int32)
    cores0 = jnp.zeros(n_pad, jnp.int32)
    rank2 = g.csr_to_csc_rank * 2
    tiers = default_tiers(g)

    def dense_dec(ops):
        """Per-dst count of in-edges from peeled sources (gather-free
        sweep; the peel bit rides inside the sort key)."""
        (peel,) = ops
        peel_csr = expand_to_edges(
            peel.astype(jnp.int32), g.row_offsets, g.m_pad
        )
        peel_csc = apply_fixed_perm_bit(rank2, peel_csr)
        return reduce_csc_by_dst(g, peel_csc, "sum")

    def make_sparse_dec(capv, cape):
        def sparse_dec(ops):
            """Bounded expansion of the (usually small) peel set —
            decrement via a capacity-sized scatter-add.  NOTE: expansion
            uses the ORIGINAL degrees, so edges into already-removed
            vertices still decrement (their degree goes negative exactly
            as in the reference's atomicAdd, `kcore/kcore_functor.hxx:34`
            — identical to the dense sweep's edge set)."""
            (peel,) = ops
            idx, cnt, _ = compact_frontier(peel, capv)
            _, dst, _, valid, _ = expand_frontier(g, idx, cnt, cape)
            dec_ext = jnp.zeros(n_pad + 1, jnp.int32)
            dec_ext = dec_ext.at[jnp.where(valid, dst, n_pad)].add(
                1, mode="drop"
            )
            return dec_ext[:n_pad]

        return sparse_dec

    branches = [make_sparse_dec(cv, ce) for cv, ce in tiers] + [dense_dec]

    def peel_round(state):
        deg, cores, k, iters = state
        peel = (deg < k) & (deg > 0)
        cores = jnp.where(peel, k - 1, cores)
        fe = frontier_edge_count(g, peel)
        fl = jnp.sum(peel, dtype=jnp.int32)
        tier_idx = jnp.int32(len(tiers))
        for i in reversed(range(len(tiers))):
            cv, ce = tiers[i]
            tier_idx = jnp.where(
                (fe <= ce) & (fl <= cv), jnp.int32(i), tier_idx
            )
        dec = jax.lax.switch(tier_idx, branches, (peel,))
        deg = jnp.where(peel, 0, deg - dec)
        return deg, cores, k, iters + 1

    def peel_cond(state):
        deg, _, k, _ = state
        return jnp.any((deg < k) & (deg > 0))

    INT_MAX = jnp.iinfo(jnp.int32).max

    def outer_body(state):
        deg, cores, k, largest, iters = state
        deg, cores, _, iters = jax.lax.while_loop(
            peel_cond, peel_round, (deg, cores, k, iters)
        )
        survivors = jnp.sum((deg >= k).astype(jnp.int32))
        done = survivors == 0
        largest = jnp.where(done, k - 1, largest)
        # level jumping: k values in (k, min surviving degree] peel nothing
        # (a vertex with degree d first peels at k = d+1), so hop straight
        # there — identical cores, outer trips drop from max_degree to the
        # number of distinct occupied degree levels
        min_deg = jnp.min(jnp.where(deg > 0, deg, INT_MAX))
        next_k = jnp.maximum(k + 1, jnp.where(done, k + 1, min_deg + 1))
        return deg, cores, next_k, largest, iters

    def outer_cond(state):
        _, _, k, largest, _ = state
        return (largest < 0) & (k <= max_k)

    _, cores, _, largest, iters = jax.lax.while_loop(
        outer_cond,
        outer_body,
        (deg0, cores0, jnp.int32(1), jnp.int32(-1), jnp.int32(0)),
    )
    return KCoreResult(cores, largest, iters)


@jax.jit
def _kcore_hindex_impl(g: GraphSlice):
    n_pad, m_pad = g.n_pad, g.m_pad
    maxd = int(g.max_out_degree)
    bits_v = max(1, (maxd + 1).bit_length())
    bits_n = (n_pad - 1).bit_length()
    pack32 = bits_n + bits_v <= 31

    # Within-segment 1-based rank per CSC position (groups by dst), gather-
    # free: iota minus each segment's start expanded to its edges.
    starts_e = expand_to_edges(
        g.col_offsets[:-1].astype(jnp.int32), g.col_offsets, m_pad
    )
    rank1 = jnp.arange(m_pad, dtype=jnp.int32) - starts_e + 1

    def h_step(h):
        # h[src] per CSR edge (pure expansion), then one sort grouping by
        # (dst asc, value desc).  Groups land exactly on the CSC segments
        # (same per-dst counts), so the static col_offsets/rank apply.
        val_e = expand_to_edges(h, g.row_offsets, m_pad)
        if pack32:
            key = g.csr_dsts * jnp.int32(1 << bits_v) + (
                jnp.int32(maxd) - val_e
            )
            skey = jax.lax.sort(key)
            sval = jnp.int32(maxd) - (skey & jnp.int32((1 << bits_v) - 1))
        else:
            _, sneg = jax.lax.sort(
                (g.csr_dsts, jnp.int32(maxd) - val_e), num_keys=2
            )
            sval = jnp.int32(maxd) - sneg
        ok = (sval >= rank1).astype(jnp.int32)
        return contiguous_segment_sum(ok, g.col_offsets)

    def body(state):
        h, _, it = state
        newh = h_step(h)
        return newh, jnp.any(newh != h), it + 1

    def cond(state):
        _, changed, _ = state
        return changed

    h0 = g.out_degrees.astype(jnp.int32)
    h, _, iters = jax.lax.while_loop(
        cond, body, (h0, jnp.bool_(True), jnp.int32(0))
    )
    real = jnp.arange(n_pad) < g.n
    largest = jnp.max(jnp.where(real, h, 0))
    return KCoreResult(h, largest, iters)


def kcore(g: GraphSlice, variant: str = "auto") -> KCoreResult:
    """``variant``: "mini" = reference peeling semantics (oracle:
    ``kcore_cpu``); "hindex" = true core numbers, undirected only (oracle:
    ``kcore_cpu_true``); "auto" = hindex when undirected else mini."""
    if variant == "auto":
        variant = "mini" if g.directed else "hindex"
    if variant == "hindex":
        if g.directed:
            raise ValueError(
                "variant='hindex' requires an undirected graph (the "
                "h-index fixpoint equals coreness only when in- and "
                "out-neighborhoods coincide)"
            )
        return _kcore_hindex_impl(g)
    # k never needs to exceed max degree + 1
    max_k = int(np.asarray(g.out_degrees).max()) + 1
    return _kcore_impl(g, max_k)


def kcore_cpu(hg: HostGraph) -> tuple[np.ndarray, int]:
    """NumPy oracle mirroring the reference CPU peeling
    (`kcore/kcore_problem.hxx:54-105`) — except the k loop runs to
    max_degree+1 rather than the reference's num_nodes cap
    (`kcore/kcore_enactor.hxx:45`), which silently under-peels multigraphs
    whose core numbers exceed n."""
    deg = hg.out_degrees.astype(np.int64).copy()
    cores = np.zeros(hg.n, dtype=np.int32)
    largest = -1
    for k in range(1, int(max(deg.max(initial=0), 0)) + 2):
        while True:
            peel = (deg < k) & (deg > 0)
            if not peel.any():
                break
            cores[peel] = k - 1
            dec = np.zeros(hg.n, dtype=np.int64)
            active = peel[hg.csr_srcs]
            np.add.at(dec, hg.csr_dsts[active], 1)
            deg = np.where(peel, 0, deg - dec)
        if (deg >= k).sum() == 0:
            largest = k - 1
            break
    return cores, largest


def kcore_cpu_true(hg: HostGraph) -> tuple[np.ndarray, int]:
    """True core numbers (multigraph-aware peeling): at level k remove
    every live vertex whose degree among LIVE vertices is < k; core = k-1
    at removal.  Unlike the reference semantics (``kcore_cpu``), edges into
    already-removed vertices never decrement, so parallel edges cannot
    drive a degree past 0 and rob a vertex of its core number."""
    n = hg.n
    srcs, dsts = hg.csr_srcs, hg.csr_dsts
    deg = hg.out_degrees.astype(np.int64).copy()
    alive = np.ones(n, bool)
    cores = np.zeros(n, np.int32)
    for k in range(1, int(deg.max(initial=0)) + 2):
        while True:
            peel = alive & (deg < k)
            if not peel.any():
                break
            cores[peel] = k - 1
            alive[peel] = False
            sel = peel[srcs] & alive[dsts]
            deg -= np.bincount(dsts[sel], minlength=n)
        if not alive.any():
            break
    return cores, int(cores.max(initial=0))
