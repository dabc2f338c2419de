"""Single-source shortest paths (frontier Bellman-Ford).

Reference recipe (`/root/reference/gunrock/src/sssp/sssp_enactor.hxx:40-72`):
advance relaxes ``dist[dst] = atomicMin(dist[dst], dist[src]+w)`` via a CAS
loop (`intrinsics.hxx:12-22`, `sssp/sssp_functor.hxx:20-28`), then a filter
drops -1 holes and per-iteration duplicates via a visited stamp
(`sssp/sssp_functor.hxx:12-18`), until the frontier empties.

Design: the relax step is a single segmented float-min over the
CSC-ordered edge sweep, masked by frontier membership — deterministic (min is
exact in f32, order-independent), so distances are bitwise-reproducible; the
visited-stamp dedup is subsumed by the bitmap frontier (a set, not a queue).
Predecessors are the minimum-id parent among distance-minimizing edges
(replacing the reference's benign-race pred write,
`sssp/sssp_functor.hxx:30-33`).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.engine import (
    src_vals_to_csc,
    dst_vals_to_csc,
    reduce_csc_by_dst,
)
from mini_tpu.ops.sparse import (
    relax_and_chain,
    compact_frontier,
    expand_frontier,
    frontier_edge_count,
    default_tiers,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SsspResult:
    dists: jnp.ndarray  # float32[n_pad], inf = unreachable
    preds: jnp.ndarray  # int32[n_pad], -1 for src/unreached
    num_iterations: jnp.ndarray
    num_sparse_iterations: jnp.ndarray
    sparse_overflowed: jnp.ndarray  # bool: any sparse tier dropped work
    # (must stay False under the capacity-fit tier selection; cf. the
    # reference's exit-on-overflow, `frontier.hxx:85-93`)
    num_chained_iterations: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.int32(0)
    )  # int32: sparse rounds that rode the compact chain (delta variant;
    # diagnostic for the round-5 indices->indices reentry path)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _sssp_impl(
    g: GraphSlice, src, max_iter: int, capv: int, cape: int,
    sync_cape: int = 0, with_preds: bool = True,
):
    n_pad = g.n_pad
    m_pad = g.m_pad
    inf = jnp.float32(jnp.inf)
    INT_MAX = jnp.iinfo(jnp.int32).max

    dist0 = jnp.full(n_pad, inf, jnp.float32).at[src].set(0.0)
    frontier0 = jnp.zeros(n_pad, jnp.bool_).at[src].set(True)
    # CSC-ordered cache of dist[src(e)] per edge (round-4 rewrite of the
    # dense relax — see dense_step); all-inf start = "no vertex improved
    # yet", so no setup sort is needed
    dist_csc0 = jnp.full(m_pad, inf, jnp.float32)

    # incremental-sync capacity: a bounded scatter of K out-edges (gather
    # rank + scatter) plus fixed compaction overhead, in place of the full
    # payload sort over ALL m; 0 disables the incremental path entirely
    cape_u = sync_cape

    def sync_cache(dist, vset, dist_csc):
        """Write dist[v] into the CSC slots of v's out-edges for every v
        in ``vset`` (bounded by cape_u; caller checks the fit)."""
        idx, cnt, v_ovf = compact_frontier(vset, n_pad)
        esrc, _, eid, valid, total = expand_frontier(g, idx, cnt, cape_u)
        pos = jnp.where(valid, g.csr_to_csc_rank[eid], m_pad)
        vals = jnp.where(valid, dist[esrc], 0.0)
        ext = jnp.concatenate([dist_csc, jnp.zeros(1, jnp.float32)])
        out = ext.at[pos].set(vals, mode="drop")[:m_pad]
        return out, v_ovf | (total > cape_u)

    def dense_step(ops):
        """Dense relax WITHOUT the per-round payload sort (round 4).

        Round 3 re-expanded + re-sorted the full f32 distance vector
        into CSC order every round (`src_vals_to_csc`) — the lax.sort is
        the superlinear term that produced the 27.4 MTEPS dip at s19
        (76 ms/round vs 27 at s18).  dist only changes at improved
        vertices, so the CSC-ordered dist[src] array is CACHED across
        rounds and synced by a bounded scatter over the out-edges of the
        not-yet-synced improved set; the full sort remains only as the
        fallback for rounds whose dirty set is genuinely huge.  The
        relax itself is the same masked segmented f32 min — candidates
        from stale-but-synced sources were already absorbed by earlier
        rounds' minima, so results stay BITWISE equal to the round-3
        sweep (min is exact and order-independent).  Replaces the
        reference's CAS-loop atomicMin (`sssp/sssp_functor.hxx:20-28`).
        """
        dist, frontier, it, dist_csc, unsynced = ops
        need = unsynced | frontier
        fe = frontier_edge_count(g, need)
        fl = jnp.sum(need, dtype=jnp.int32)

        def inc(dc):
            return sync_cache(dist, need, dc)

        def full(dc):
            # unmasked full rebuild: never-improved vertices carry +inf
            return src_vals_to_csc(g, dist), jnp.bool_(False)

        if cape_u > 0:
            fits = (fe <= cape_u) & (fl <= n_pad)
            dist_csc, s_ovf = jax.lax.cond(fits, inc, full, dist_csc)
        else:
            dist_csc, s_ovf = full(dist_csc)
        cand = jnp.where(
            g.edge_mask_csc, dist_csc + g.csc_weights, inf
        )
        best = reduce_csc_by_dst(g, cand, "min")
        improved = best < dist
        dist = jnp.minimum(dist, best)
        return (
            dist, improved, s_ovf, dist_csc,
            jnp.zeros(n_pad, jnp.bool_),
        )

    tiers = default_tiers(g, capv, cape) if cape > 1 else []

    def make_sparse_step(tier_capv, tier_cape):
        def sparse_step(ops):
            """Bounded compact-frontier relax: same f32 min over the same
            candidate set -> bitwise-identical to the dense sweep.  The
            dense cache is NOT touched — the round's improved set joins
            ``unsynced`` and is folded in by the next dense round."""
            dist, frontier, it, dist_csc, unsynced = ops
            idx, cnt, v_ovf = compact_frontier(frontier, tier_capv)
            esrc, edst, eid, valid, total = expand_frontier(
                g, idx, cnt, tier_cape
            )
            cand = dist[esrc] + g.csr_weights[eid]
            dstw = jnp.where(valid, edst, n_pad)
            dist_ext = jnp.concatenate([dist, jnp.full(1, inf)])
            dist2 = dist_ext.at[dstw].min(
                jnp.where(valid, cand, inf), mode="drop"
            )[:n_pad]
            improved = dist2 < dist
            return (
                dist2, improved, v_ovf | (total > tier_cape), dist_csc,
                unsynced | frontier,
            )

        return sparse_step

    branches = [make_sparse_step(cv, ce) for cv, ce in tiers] + [dense_step]

    def step(state):
        dist, frontier, it, sparses, ovf, dist_csc, unsynced = state
        fe = frontier_edge_count(g, frontier)
        fl = jnp.sum(frontier, dtype=jnp.int32)
        tier_idx = jnp.int32(len(tiers))
        for i in reversed(range(len(tiers))):
            cv, ce = tiers[i]
            tier_idx = jnp.where(
                (fe <= ce) & (fl <= cv), jnp.int32(i), tier_idx
            )
        dist, improved, step_ovf, dist_csc, unsynced = jax.lax.switch(
            tier_idx, branches, (dist, frontier, it, dist_csc, unsynced)
        )
        is_sparse = tier_idx < len(tiers)
        return (
            dist, improved, it + 1,
            sparses + is_sparse.astype(jnp.int32), ovf | step_ovf,
            dist_csc, unsynced,
        )

    def cond(state):
        _, frontier, it, _, _, _, _ = state
        return jnp.any(frontier) & (it < max_iter)

    dist, _, it, sparses, ovf, _, _ = jax.lax.while_loop(
        cond, step,
        (dist0, frontier0, jnp.int32(0), jnp.int32(0), jnp.bool_(False),
         dist_csc0, jnp.zeros(n_pad, jnp.bool_)),
    )
    return _finish(g, dist, src, it, sparses, ovf, with_preds)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _sssp_delta_impl(
    g: GraphSlice, src, max_iter: int, capv: int, cape: int, delta: float,
    with_preds: bool = True, chain_cap: int = 0,
):
    """Delta-stepping SSSP (opt-in ``sssp(variant="delta")``).

    Classic bucketed processing (Meyer & Sanders) mapped onto the tiered
    frontier machinery: the pending (improved-but-unrelaxed) set is
    processed in distance buckets ``dist < B``, ``B`` advancing by
    ``delta`` when the active bucket drains.  Bucketing keeps each
    round's frontier SMALL, so rounds ride the bounded sparse tiers
    (O(cape)) instead of the weighted Bellman-Ford's O(m) dense sweeps.  The
    fixpoint is the same exact f32 shortest-distance solution, so
    results stay bitwise-equal to the Dijkstra oracle.

    "Compact chaining": light-edge reentry rounds — the vast
    majority on the target family — run CHAINED: the next compact
    frontier is derived straight from the O(chain_cap) relaxed-edge
    arrays (`ops/sparse.relax_and_chain`), and the pending bitmap
    is maintained by two bounded scatters (clear the expanded actives,
    set the improved dsts) — skipping the O(n) bitmap top_k + fe/fl
    scans + elementwise update of a bitmap round.  Bucket boundaries and chain overflows fall back
    to the bitmap path (one O(n) round per bucket).  ``chain_cap=0``
    disables chaining (pure round-4 bitmap rounds).  A rejected
    alternative: replacing the bitmap with an implicit
    ``pending(v) == dist[v] < rel[v]`` lazy-deletion array made BITMAP
    rounds pay an O(capv) gather+scatter each and was slower on a grid —
    the bitmap stays."""
    n_pad = g.n_pad
    inf = jnp.float32(jnp.inf)
    dlt = jnp.float32(delta)

    dist0 = jnp.full(n_pad, inf, jnp.float32).at[src].set(0.0)
    pending0 = jnp.zeros(n_pad, jnp.bool_).at[src].set(True)

    tiers = default_tiers(g, capv, cape) if cape > 1 else []
    ccap = int(chain_cap) if tiers else 0

    def relax_plain(dist, idx, cnt, exp_cape):
        """Plain bounded relax (chaining disabled): expand + scatter-min."""
        esrc, edst, eid, valid, total = expand_frontier(
            g, idx, cnt, exp_cape
        )
        cand = dist[esrc] + g.csr_weights[eid]
        dstw = jnp.where(valid, edst, n_pad)
        ext = jnp.concatenate([dist, jnp.full(1, inf)])
        d2 = ext.at[dstw].min(
            jnp.where(valid, cand, inf), mode="drop"
        )[:n_pad]
        return d2, total > exp_cape

    no_chain = (
        jnp.zeros(max(ccap, 1), jnp.int32), jnp.int32(0), jnp.bool_(False)
    )

    def chained_step(state):
        """Reentry round riding the chained compact frontier: all of
        pending ∩ {dist < B} is exactly ``nidx[:ncnt]`` (established by
        whoever derived the chain), so every term is O(chain_cap)."""
        dist, pending, B, it, sparses, ovf, nidx, ncnt, nok, chained = state
        d2, sdst, imp_first, cidx, ccnt, cfe, cok, e_ovf = relax_and_chain(
            g, dist, g.csr_weights, nidx, ncnt, ccap, ccap, bound=B
        )
        # bounded bitmap maintenance: expanded actives leave pending,
        # improved dsts (re)enter — ORDER matters (an active improved
        # again stays pending); imp_first is already deduped
        act_w = jnp.where(
            jnp.arange(ccap) < ncnt, nidx, jnp.int32(n_pad)
        )
        p1 = pending.at[act_w].set(False, mode="drop")
        p2 = p1.at[jnp.where(imp_first, sdst, jnp.int32(n_pad))].set(
            True, mode="drop"
        )
        cok = cok & (cfe <= ccap)
        return (
            d2, p2, B, it + 1, sparses + 1, ovf | e_ovf,
            cidx, ccnt, cok, chained + 1,
        )

    def bitmap_step(state):
        """Bucket-boundary / fallback round (the round-4 recipe):
        advance B when the bucket drained, relax through the tier
        machinery, update pending elementwise, and (re)enter chained
        mode when the sparse tier ran and its chain fits."""
        dist, pending, B, it, sparses, ovf, _, _, _, chained = state
        active = pending & (dist < B)
        has_active = jnp.any(active)
        # bucket drained: advance B to the next pending bucket boundary
        # (jump straight to floor(min_pending/delta+1)*delta — no empty
        # spin rounds)
        min_pend = jnp.min(jnp.where(pending, dist, inf))
        B_next = (jnp.floor(min_pend / dlt) + 1.0) * dlt
        # f32 progress guard: when min_pend/delta >= 2^24 the
        # floor+1 round-trip can round B_next back to <= min_pend, leaving
        # the active set empty forever; force B strictly past min_pend
        B_next = jnp.maximum(B_next, jnp.nextafter(min_pend, inf))
        B = jnp.where(has_active, B, B_next)
        active = pending & (dist < B)

        fe = frontier_edge_count(g, active)
        fl = jnp.sum(active, dtype=jnp.int32)

        def dense(ops):
            d_, f_ = ops
            dm = jnp.where(f_, d_, inf)
            cand = jnp.where(
                g.edge_mask_csc,
                src_vals_to_csc(g, dm) + g.csc_weights, inf,
            )
            best = reduce_csc_by_dst(g, cand, "min")
            d2 = jnp.minimum(d_, best)
            return (d2, jnp.bool_(False)) + no_chain

        def make_sparse(cv, ce):
            def sp(ops):
                d_, f_ = ops
                idx, cnt, v_ovf = compact_frontier(f_, cv)
                if ccap == 0:
                    d2, e_ovf = relax_plain(d_, idx, cnt, ce)
                    return (d2, v_ovf | e_ovf) + no_chain
                d2, _, _, cidx, ccnt, cfe, cok, e_ovf = relax_and_chain(
                    g, d_, g.csr_weights, idx, cnt, ce, ccap, bound=B
                )
                cok = cok & (cfe <= ccap)
                return d2, v_ovf | e_ovf, cidx, ccnt, cok

            return sp

        branches = [make_sparse(cv, ce) for cv, ce in tiers] + [dense]
        tier_idx = jnp.int32(len(tiers))
        for i in reversed(range(len(tiers))):
            cv, ce = tiers[i]
            tier_idx = jnp.where(
                (fe <= ce) & (fl <= cv), jnp.int32(i), tier_idx
            )
        d2, step_ovf, cidx, ccnt, cok = jax.lax.switch(
            tier_idx, branches, (dist, active)
        )
        # settled vertices of this bucket leave pending; improvements
        # (re)enter — a vertex improved into the CURRENT bucket is
        # re-processed next round (light-edge reentry), one improved
        # past B waits for its bucket
        pending = (pending & ~active) | (d2 < dist)
        used_sparse = tier_idx < len(tiers)
        return (
            d2, pending, B, it + 1,
            sparses + used_sparse.astype(jnp.int32), ovf | step_ovf,
            cidx, ccnt, cok, chained,
        )

    if ccap > 0:
        def step(state):
            return jax.lax.cond(state[8], chained_step, bitmap_step, state)
    else:
        step = bitmap_step

    def cond(state):
        _, pending, _, it = state[0], state[1], state[2], state[3]
        return jnp.any(pending) & (it < max_iter)

    state = (
        dist0, pending0, dlt, jnp.int32(0), jnp.int32(0), jnp.bool_(False),
    ) + no_chain + (jnp.int32(0),)
    out = jax.lax.while_loop(cond, step, state)
    dist, it, sparses, ovf = out[0], out[3], out[4], out[5]
    return _finish(g, dist, src, it, sparses, ovf, with_preds, out[9])


def _finish(g, dist, src, it, sparses, ovf, with_preds: bool = True,
            chained=None):
    INT_MAX = jnp.iinfo(jnp.int32).max
    chained = jnp.int32(0) if chained is None else chained
    if not with_preds:
        # ``with_preds=False`` (batch sweeps that only need distances)
        # skips the pred post-pass — two payload sorts + a reduce per
        # source (same rationale as bfs._bfs_impl's flag)
        preds = jnp.full(g.n_pad, -1, jnp.int32)
        return SsspResult(dist, preds, it, sparses, ovf, chained)
    # predecessors in one post-pass: pred[v] = min{u : dist[u]+w == dist[v]}
    # (f32 sums recomputed identically to the relax step -> bitwise match)
    d_src = src_vals_to_csc(g, dist)
    d_dst = dst_vals_to_csc(g, dist)
    ok = (
        (d_src + g.csc_weights == d_dst)
        & jnp.isfinite(d_dst)
        & g.edge_mask_csc
    )
    pred_min = reduce_csc_by_dst(
        g, jnp.where(ok, g.csc_srcs, INT_MAX), "min"
    )
    preds = jnp.where(
        jnp.isfinite(dist) & (pred_min != INT_MAX), pred_min, -1
    ).astype(jnp.int32)
    preds = preds.at[src].set(-1)
    return SsspResult(dist, preds, it, sparses, ovf, chained)


def sssp(
    g: GraphSlice,
    src: int,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    sync_cape: int | None = None,
    variant: str = "bellman",
    delta: float | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> SsspResult:
    """``variant="delta"`` runs delta-stepping (bucketed frontiers that
    ride the sparse tiers — see ``_sssp_delta_impl``); ``delta`` is the
    bucket width (default: mean edge weight, a standard heuristic).
    ``variant="auto"`` picks delta-stepping when the graph's estimated
    round count is large (high-diameter weighted graphs — grids, road
    networks, meshes) and Bellman-Ford otherwise; see
    :func:`_auto_variant`.  ``with_preds=False`` skips the predecessor
    post-pass (two payload sorts + a reduce).  ``chain_cap`` bounds the
    compact-chained reentry rounds of the delta variant (0 disables
    chaining; None = default, see :func:`_default_chain_cap`)."""
    if max_iter is None:
        max_iter = g.n_pad  # Bellman-Ford converges in <= n-1 rounds
    # 0 disables the sparse path; None lets ops/sparse.default_tiers pick
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if sync_cape is None:
        # Incremental dense-cache sync capacity; 0 (default) = full
        # rebuild every dense round.  Weighted Bellman-Ford rounds on RMAT
        # carry improvement sets too large for the bounded sync to pay;
        # it is opt-in for low-improvement-rate workloads (near-BFS weight
        # distributions, incremental re-solves); pass e.g. m_pad//32.
        sync_cape = 0
    if variant == "auto":
        variant = _auto_variant(g)
    if variant == "delta":
        delta = _default_delta(g) if delta is None else delta
        if chain_cap is None:
            chain_cap = _default_chain_cap(g, int(sparse_cape))
        return _sssp_delta_impl(
            g, jnp.asarray(src), int(max_iter), int(sparse_capv),
            int(sparse_cape), float(delta), bool(with_preds),
            int(chain_cap),
        )
    if variant != "bellman":
        raise ValueError(f"unknown variant {variant!r}")
    return _sssp_impl(
        g, jnp.asarray(src), int(max_iter), int(sparse_capv),
        int(sparse_cape), int(sync_cape), bool(with_preds),
    )


from mini_tpu.ops.sparse import default_chain_cap as _default_chain_cap


def _default_delta(g: GraphSlice) -> float:
    """Default bucket width: a degree-keyed multiple of the mean edge
    weight.

    Each round carries a fixed floor cost, so round COUNT binds, not
    per-round work — the optimum is the WIDEST bucket whose frontiers
    still fit the bounded sparse tier (wider -> fewer rounds, too wide
    -> dense spill), wider than the textbook delta (~mean weight).  That
    boundary is family-dependent: grid-like graphs (deg~4) tolerate 64x
    the mean, delaunay-like (deg~6) spill past 4x, and high-degree RMAT
    is flat in delta.  The multiples are due to be re-fitted on the GPU
    (ROADMAP.md)."""
    w = np.asarray(g.csc_weights)
    mask = np.asarray(g.edge_mask_csc)
    if not mask.any():
        return 1.0
    deg = float(np.asarray(g.out_degrees)[: int(g.n)].mean())
    mult = 64.0 if deg < 4.5 else (4.0 if deg < 8.0 else 16.0)
    return float(max(mult * w[mask].mean(), 1e-6))


def _auto_variant(g: GraphSlice) -> str:
    """Pick the SSSP variant from a cheap family proxy.

    Delta-stepping with the wide default bucket keeps every round of a
    grid on the bounded sparse tiers, where Bellman-Ford falls to dense
    rounds; on RMAT the two are close.  Mean out-degree <
    ``_AUTO_DEGREE_THRESHOLD`` selects the mesh/road-network family
    (grid ~4, delaunay ~6, RMAT-ef16 ~32) where bucketing pays.
    Host-side and O(1) (uses the prebuilt degree array).
    """
    deg = float(np.asarray(g.out_degrees)[: int(g.n)].mean())
    return "delta" if deg < _AUTO_DEGREE_THRESHOLD else "bellman"


# mean out-degree below which _auto_variant picks delta-stepping: the
# low-degree mesh families
_AUTO_DEGREE_THRESHOLD = 8.0


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _sssp_batch_impl(g, srcs, max_iter, capv, cape, sync_cape, with_preds):
    def body(_, s):
        return None, _sssp_impl(
            g, s, max_iter, capv, cape, sync_cape, with_preds
        )

    _, res = jax.lax.scan(body, None, srcs)
    return res


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _sssp_batch_delta_impl(
    g, srcs, max_iter, capv, cape, delta, with_preds, chain_cap
):
    def body(_, s):
        return None, _sssp_delta_impl(
            g, s, max_iter, capv, cape, delta, with_preds, chain_cap
        )

    _, res = jax.lax.scan(body, None, srcs)
    return res


def sssp_batch(
    g: GraphSlice,
    srcs,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    sync_cape: int | None = None,
    variant: str = "bellman",
    delta: float | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> SsspResult:
    """Multi-source SSSP in one jitted ``lax.scan`` over sources — the
    dispatch-amortized batch form (see :func:`mini_tpu.algorithms.bfs.
    bfs_batch` for the design rationale).  Each result field gains a
    leading ``[len(srcs)]`` axis; bitwise-identical to per-source calls.
    ``variant``/``delta``/``with_preds`` mirror :func:`sssp` (
    the CLI's ``--sources`` form previously dropped the variant)."""
    if max_iter is None:
        max_iter = g.n_pad
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if sync_cape is None:
        sync_cape = 0  # see sssp(): full rebuild is the default
    srcs = jnp.atleast_1d(jnp.asarray(srcs, jnp.int32))
    if variant == "auto":
        variant = _auto_variant(g)
    if variant == "delta":
        delta = _default_delta(g) if delta is None else delta
        if chain_cap is None:
            chain_cap = _default_chain_cap(g, int(sparse_cape))
        return _sssp_batch_delta_impl(
            g, srcs, int(max_iter), int(sparse_capv), int(sparse_cape),
            float(delta), bool(with_preds), int(chain_cap),
        )
    if variant != "bellman":
        raise ValueError(f"unknown variant {variant!r}")
    return _sssp_batch_impl(
        g, srcs, int(max_iter), int(sparse_capv), int(sparse_cape),
        int(sync_cape), bool(with_preds),
    )


def sssp_cpu(hg: HostGraph, src: int) -> tuple[np.ndarray, np.ndarray]:
    """NumPy/heapq oracle: Dijkstra in float32 (the reference oracle,
    `sssp/sssp_problem.hxx:59-88`, truncates weights to int — fixed here).

    Relaxations compute ``dist[u] + w`` in float32 exactly as the device
    does, so resulting distances are bitwise-comparable.
    """
    dist = np.full(hg.n, np.inf, dtype=np.float32)
    preds = np.full(hg.n, -1, dtype=np.int64)
    dist[src] = 0.0
    pq = [(np.float32(0.0), src)]
    done = np.zeros(hg.n, dtype=bool)
    while pq:
        d, u = heapq.heappop(pq)
        if done[u]:
            continue
        done[u] = True
        for e in range(hg.row_offsets[u], hg.row_offsets[u + 1]):
            v = hg.csr_dsts[e]
            nd = np.float32(dist[u] + hg.csr_weights[e])
            if nd < dist[v]:
                dist[v] = nd
                preds[v] = u
                heapq.heappush(pq, (nd, int(v)))
    return dist, preds


def validate_pred_tree(
    dists: np.ndarray, preds: np.ndarray, hg: HostGraph, src: int
) -> bool:
    """preds must form a shortest-path tree: dist[v] == dist[pred] + w for
    some edge (pred, v).  (Pred arrays are not unique when shortest paths
    tie, so comparing against Dijkstra's preds elementwise — as the
    reference does, `tests/sssp/test_sssp.cu:48` — is only valid on
    tie-free graphs; this check is the robust version.)"""
    edge_w: dict[tuple[int, int], float] = {}
    for s, d, w in zip(hg.csr_srcs, hg.csr_dsts, hg.csr_weights):
        key = (int(s), int(d))
        edge_w[key] = min(edge_w.get(key, np.inf), float(w))
    for v in range(hg.n):
        if v == src or not np.isfinite(dists[v]):
            continue
        p = int(preds[v])
        if p < 0 or (p, v) not in edge_w:
            return False
        if np.float32(dists[p] + np.float32(edge_w[(p, v)])) != dists[v]:
            return False
    return True
