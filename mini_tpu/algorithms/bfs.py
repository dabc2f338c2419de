"""Direction-optimal BFS.

Reference recipe (`/root/reference/gunrock/src/bfs/bfs_enactor.hxx:41-117`):
push loop = advance(label==-1 -> atomicCAS label=iter+1, record pred) +
filter(compact -1 holes), switching to a Ligra-style pull loop
(bitmap + advance_backward over CSC) when
``num_unvisited < frontier_len * alpha``.

Design: labels/preds/frontier are dense arrays updated by
deterministic segment reductions; the whole loop runs on device under
``lax.while_loop`` (the reference pays a device->host sync per iteration,
`advance.hxx:43`).  Push masks edges by frontier[src]; pull masks by
unvisited[dst] and frontier[src] over the same CSC-ordered edge sweep — in
the dense engine both directions touch every edge, so the ``alpha`` switch
selects the masking form (and is the hook for the sparse-gather push path);
results are identical and bitwise-deterministic either way.

Predecessors: the reference records *some* improving parent via a benign
race (`bfs/bfs_functor.hxx:30-33`); we deterministically record the
minimum-id parent at the minimal depth.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.engine import (
    src_vals_to_csc,
    dst_vals_to_csc,
    reduce_csc_by_dst,
)
from mini_tpu.ops.frontier import Frontier
from mini_tpu.ops.operators import advance, compute
from mini_tpu.ops.sparse import (
    compact_frontier,
    expand_frontier,
    frontier_edge_count,
    default_tiers,
    default_chain_cap,
    visit_and_chain,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BfsResult:
    labels: jnp.ndarray  # int32[n_pad]: hop distance, -1 unreachable
    preds: jnp.ndarray  # int32[n_pad]: min-id parent, -1 for src/unreached
    num_iterations: jnp.ndarray  # int32
    num_pull_iterations: jnp.ndarray  # int32: iterations run in pull mode
    num_sparse_iterations: jnp.ndarray  # int32: iterations on the sparse path
    sparse_overflowed: jnp.ndarray  # bool: any sparse tier dropped work
    # (must stay False — tier selection is capacity-fit; a True here means
    # the fit precondition broke and the result may be wrong.  The
    # reference exits on frontier overflow, `frontier.hxx:85-93`; we
    # return the flag instead of killing the device loop.)
    num_chained_iterations: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.int32(0)
    )  # int32: sparse rounds that rode the compact chain (round 5)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _bfs_impl(
    g: GraphSlice, src, alpha: float, max_iter: int, capv: int, cape: int,
    with_preds: bool = True, chain_cap: int = 0,
):
    n_pad = g.n_pad
    INT_MAX = jnp.iinfo(jnp.int32).max

    labels0 = jnp.full(n_pad, -1, jnp.int32).at[src].set(0)

    tiers = default_tiers(g, capv, cape) if cape > 1 else []
    ccap = int(chain_cap) if tiers else 0

    # Round-5 compact chaining (cf. algorithms/sssp._sssp_delta_impl):
    # a sparse round's next frontier is exactly its newly visited dsts,
    # already sitting in the O(cape) edge arrays — so reentry rounds
    # chain indices->indices (ops/sparse.visit_and_chain) with no O(n)
    # work at all.  BFS needs NO bitmap maintenance either: the current
    # frontier is always reconstructible as ``labels == it``, which is
    # what the bitmap/dense rounds (and cond) use.
    no_chain = (
        jnp.zeros(max(ccap, 1), jnp.int32), jnp.int32(0), jnp.bool_(False)
    )

    def dense_step(ops):
        """Full-edge gather-free sweep through the operator layer
        (ops/operators.advance + compute): the frontier bit rides inside
        the advance's sort key (ops/engine.src_bits_to_csc), the
        label==-1 functor is the reference's ``cond_advance``
        (`bfs/bfs_functor.hxx:26-28`), and the label stamp is the
        ``compute`` operator — bitwise-identical to (and compiled the
        same as) the raw engine calls."""
        labels, frontier, it = ops
        unvisited = dst_vals_to_csc(
            g, (labels == -1).astype(jnp.int32)
        )
        nxt, _, _ = advance(
            g, Frontier(frontier), cond=lambda ev: unvisited > 0,
            direction="push",
        )
        labels = compute(nxt, lambda l: jnp.full_like(l, it + 1), labels)
        return (labels, jnp.bool_(False)) + no_chain

    def make_sparse_step(tier_capv, tier_cape):
        def sparse_step(ops):
            """Bounded compact-frontier push (O(capacity), not O(m)) — the
            reference's LB sparse advance re-expressed (ops/sparse.py)."""
            labels, frontier, it = ops
            idx, cnt, v_ovf = compact_frontier(frontier, tier_capv)
            if ccap == 0:
                _, dst, _, valid, total = expand_frontier(
                    g, idx, cnt, tier_cape
                )
                sel = valid & (labels[dst] == -1)
                dstw = jnp.where(sel, dst, n_pad)
                labels = jnp.concatenate(
                    [labels, jnp.full(1, -1, jnp.int32)]
                ).at[dstw].set(it + 1, mode="drop")[:n_pad]
                return (labels, v_ovf | (total > tier_cape)) + no_chain
            labels2, cidx, ccnt, cfe, cok, e_ovf = visit_and_chain(
                g, labels, idx, cnt, tier_cape, ccap, it + 1
            )
            cok = cok & (cfe <= ccap)
            return labels2, v_ovf | e_ovf, cidx, ccnt, cok

        return sparse_step

    branches = [make_sparse_step(cv, ce) for cv, ce in tiers] + [dense_step]

    def chained_step(state):
        """Reentry round riding the chained compact frontier — every
        term O(chain_cap)."""
        labels, it, pulls, sparses, ovf, nidx, ncnt, nok, chained = state
        labels2, cidx, ccnt, cfe, cok, e_ovf = visit_and_chain(
            g, labels, nidx, ncnt, ccap, ccap, it + 1
        )
        cok = cok & (cfe <= ccap)
        return (
            labels2, it + 1, pulls, sparses + 1, ovf | e_ovf,
            cidx, ccnt, cok, chained + 1,
        )

    def bitmap_step(state):
        labels, it, pulls, sparses, ovf, _, _, _, chained = state
        frontier = labels == it  # reconstructed; no bitmap state at all
        frontier_len = jnp.sum(frontier, dtype=jnp.int32)
        num_unvisited = jnp.sum(
            (labels == -1) & (jnp.arange(n_pad) < g.n)
        )
        use_pull = num_unvisited.astype(jnp.float32) < (
            frontier_len.astype(jnp.float32) * alpha
        )
        # direction-optimal switch: smallest sparse capacity tier that fits
        # the frontier's edge work, dense sweep otherwise (the reference
        # switches push->pull on the alpha heuristic,
        # `bfs/bfs_enactor.hxx:68`; capacity-fit is the exact work-based
        # criterion and alpha is kept for accounting/tuning)
        fe = frontier_edge_count(g, frontier)
        tier_idx = jnp.int32(len(tiers))  # dense default
        for i in reversed(range(len(tiers))):
            cv, ce = tiers[i]
            fits = (fe <= ce) & (frontier_len <= cv)
            tier_idx = jnp.where(fits, jnp.int32(i), tier_idx)
        tier_idx = jnp.where(use_pull, jnp.int32(len(tiers)), tier_idx)
        labels, step_ovf, cidx, ccnt, cok = jax.lax.switch(
            tier_idx, branches, (labels, frontier, it)
        )
        is_sparse = tier_idx < len(tiers)
        return (
            labels,
            it + 1,
            pulls + use_pull.astype(jnp.int32),
            sparses + is_sparse.astype(jnp.int32),
            ovf | step_ovf,
            cidx, ccnt, cok, chained,
        )

    if ccap > 0:
        def step(state):
            return jax.lax.cond(state[7], chained_step, bitmap_step, state)
    else:
        step = bitmap_step

    def cond(state):
        labels, it = state[0], state[1]
        return jnp.any(labels == it) & (it < max_iter)

    state = (
        labels0, jnp.int32(0), jnp.int32(0), jnp.int32(0),
        jnp.bool_(False),
    ) + no_chain + (jnp.int32(0),)
    out = jax.lax.while_loop(cond, step, state)
    labels, it, pulls, sparses, ovf, chained = (
        out[0], out[1], out[2], out[3], out[4], out[8]
    )

    # predecessors reconstructed in one post-pass (equivalent to recording
    # the min-id parent at discovery time): pred[v] = min{u : (u,v) in E,
    # labels[u] == labels[v]-1}.  ``with_preds=False`` (batch sweeps that
    # only need depths) skips the post-pass — it costs one expansion +
    # one payload sort + one scan per source (~6.8 ms/src at rmat16)
    if with_preds:
        lab_src_csc = src_vals_to_csc(g, labels)
        lab_dst_csc = dst_vals_to_csc(g, labels)
        cand = (
            (lab_src_csc == lab_dst_csc - 1)
            & (lab_dst_csc > 0)
            & g.edge_mask_csc
        )
        pred_min = reduce_csc_by_dst(
            g, jnp.where(cand, g.csc_srcs, INT_MAX), "min"
        )
        preds = jnp.where(
            (labels > 0) & (pred_min != INT_MAX), pred_min, -1
        ).astype(jnp.int32)
    else:
        preds = jnp.full(n_pad, -1, jnp.int32)
    return BfsResult(labels, preds, it, pulls, sparses, ovf, chained)


def _auto_chain_cap(g: GraphSlice, sparse_cape: int) -> int:
    """Default BFS chain capacity from a cheap family proxy.

    Chaining pays when every BFS round fits the chain (grids, road
    networks); on Delaunay-like meshes frontiers outgrow it within a few
    dozen rounds, and on RMAT the dense/pull tiers take over.  Mean
    out-degree < 5 selects the grid/road-network family where BFS
    wavefronts stay narrow; everything else keeps chaining off.  The
    mean comes from the static ``m / n``, so ``bfs`` traces under
    ``jax.jit`` with the graph as an argument.  (SSSP delta-stepping
    keeps chaining unconditionally — its bucketing bounds the frontier
    by construction.)"""
    deg = g.m / max(g.n, 1)
    return default_chain_cap(g, sparse_cape) if deg < 5.0 else 0


def bfs(
    g: GraphSlice,
    src: int,
    alpha: float | None = None,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    chain_cap: int | None = None,
) -> BfsResult:
    """Run BFS from ``src``.  ``alpha`` is the push->pull switch threshold
    (reference default ``1/num_nodes``, `tests/bfs/test_bfs.cu:30`);
    ``sparse_capv``/``sparse_cape`` bound the compact-push path (0 disables).
    ``chain_cap`` bounds the compact-chained reentry rounds (round 5;
    0 disables chaining, None = the family default).
    """
    if alpha is None:
        alpha = 1.0 / max(g.n, 1)
    if max_iter is None:
        max_iter = g.n_pad
    # 0 disables the sparse path; None lets ops/sparse.default_tiers pick
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if chain_cap is None:
        chain_cap = _auto_chain_cap(g, int(sparse_cape))
    return _bfs_impl(
        g,
        jnp.asarray(src),
        float(alpha),
        int(max_iter),
        int(sparse_capv),
        int(sparse_cape),
        True,
        int(chain_cap),
    )


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _bfs_batch_impl(g, srcs, alpha, max_iter, capv, cape, with_preds,
                    chain_cap):
    def body(_, s):
        r = _bfs_impl(g, s, alpha, max_iter, capv, cape, with_preds,
                      chain_cap)
        return None, r

    _, res = jax.lax.scan(body, None, srcs)
    return res


def bfs_batch(
    g: GraphSlice,
    srcs,
    alpha: float | None = None,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> BfsResult:
    """Multi-source BFS (Graph500-style batch): runs the single-source
    program once per source inside ONE jitted ``lax.scan``, so the
    per-dispatch host cost amortizes across the batch.  Every field of the
    returned :class:`BfsResult` gains a leading ``[len(srcs)]`` axis;
    results are bitwise-identical to per-source :func:`bfs` calls.

    A ``scan`` (sequential) rather than ``vmap``: under vmap the
    direction-optimal ``lax.switch`` degrades to executing EVERY tier per
    round for masked selection, forfeiting the sparse-tier win.

    Reference: multi-source runs exist only as repeated CLI invocations
    (`/root/reference/gunrock/tests/bfs/test_bfs.cu:29-31`, ``--src``).
    """
    if alpha is None:
        alpha = 1.0 / max(g.n, 1)
    if max_iter is None:
        max_iter = g.n_pad
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if chain_cap is None:
        chain_cap = _auto_chain_cap(g, int(sparse_cape))
    srcs = jnp.atleast_1d(jnp.asarray(srcs, jnp.int32))
    return _bfs_batch_impl(
        g, srcs, float(alpha), int(max_iter), int(sparse_capv),
        int(sparse_cape), bool(with_preds), int(chain_cap),
    )


def bfs_cpu(hg: HostGraph, src: int) -> np.ndarray:
    """NumPy oracle: level-synchronous BFS (matches the reference's queue BFS
    with label relaxation, `bfs/bfs_problem.hxx:52-72`)."""
    labels = np.full(hg.n, -1, dtype=np.int32)
    labels[src] = 0
    frontier = np.zeros(hg.n, dtype=bool)
    frontier[src] = True
    level = 0
    while frontier.any():
        nxt = np.zeros(hg.n, dtype=bool)
        active = frontier[hg.csr_srcs] & (labels[hg.csr_dsts] == -1)
        nxt[hg.csr_dsts[active]] = True
        labels[nxt] = level + 1
        frontier = nxt
        level += 1
    return labels


def validate_preds(
    labels: np.ndarray, preds: np.ndarray, hg: HostGraph, src: int
) -> bool:
    """Check the predecessor array encodes a valid BFS tree: every reached
    vertex but ``src`` has a parent one level up, joined to it by an edge.

    Vectorized: CSR edges are sorted by (src, dst), so the keys
    ``src * n + dst`` are sorted and one ``searchsorted`` tests all
    parent edges at once."""
    labels = np.asarray(labels)[: hg.n]
    preds = np.asarray(preds)[: hg.n].astype(np.int64)
    v = np.flatnonzero(labels > 0)  # src has label 0
    if v.size == 0:
        return True
    p = preds[v]
    if np.any((p < 0) | (p >= hg.n)):
        return False
    if np.any(labels[p] != labels[v] - 1):
        return False
    keys = hg.csr_srcs.astype(np.int64) * hg.n + hg.csr_dsts
    want = p * hg.n + v
    pos = np.minimum(np.searchsorted(keys, want), hg.m - 1)
    return hg.m > 0 and bool(np.all(keys[pos] == want))
