"""The frontier-to-frontier operator set: advance / filter / neighborhood /
compute.

Reference semantics being re-expressed (see SURVEY.md §2.1):

* ``advance`` (`/root/reference/gunrock/src/advance.hxx:21-160`): expand each
  frontier vertex's neighbors, evaluate a per-edge cond/apply functor, emit
  the touched destinations as the next frontier.  The reference does a degree
  scan + host readback + moderngpu ``transform_lbs``; here it is one
  vectorized edge sweep, masked by frontier membership, with deterministic
  segment reductions applying the state updates.
* ``filter`` (`filter.hxx:12-31`): stream compaction by predicate — a pure
  mask-and on bitmap frontiers.
* ``neighborhood`` (`neighborhood.hxx:13-70`): segmented reduce of per-
  neighbor values — the SpMV shape; the Value-typed reduce generalizes to
  SpMM for GNNs (see ops/spmm.py).
* ``compute``: per-element map over the frontier.  Listed as TODO in the
  reference (`README.md:19`, never implemented) — implemented here.

Direction: ``push`` walks out-edges of the frontier (CSR semantics), ``pull``
walks in-edges (CSC).  Both are implemented as sweeps over the *CSC-ordered*
edge array when the reduction is keyed by destination (segment ids must be
sorted) and over the CSR-ordered array when keyed by source.

Per-edge functors are plain Python callables taking an ``EdgeView`` and
returning arrays over edges; they trace into the jitted sweep — in the role
of the reference's ``--expt-extended-lambda`` device functors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from mini_tpu.graph.csr import GraphSlice
from mini_tpu.ops.frontier import Frontier
from mini_tpu.ops.segment import identity_for


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EdgeView:
    """Per-edge arrays handed to functors.

    ``rank`` is the edge's position within its segment (the reference's
    ``rank`` arg from transform_lbs, `advance.hxx:53-62`); ``eid`` is the
    CSR edge id (stable across CSR/CSC views).
    """

    src: jnp.ndarray  # int32[m_pad]
    dst: jnp.ndarray  # int32[m_pad]
    weight: jnp.ndarray  # float32[m_pad]
    eid: jnp.ndarray  # int32[m_pad]
    rank: jnp.ndarray  # int32[m_pad]
    mask: jnp.ndarray  # bool[m_pad] — real (non-ghost) edges


def edges_by_dst(g: GraphSlice) -> EdgeView:
    """Edge view in CSC order (segment ids = dst, sorted)."""
    return EdgeView(
        src=g.csc_srcs,
        dst=g.csc_dsts,
        weight=g.csc_weights,
        eid=g.csc_eids,
        rank=g.csc_ranks(),
        mask=g.edge_mask_csc,
    )


def edges_by_src(g: GraphSlice) -> EdgeView:
    """Edge view in CSR order (segment ids = src, sorted)."""
    return EdgeView(
        src=g.csr_srcs,
        dst=g.csr_dsts,
        weight=g.csr_weights,
        eid=jnp.arange(g.m_pad, dtype=jnp.int32),
        rank=g.csr_ranks(),
        mask=g.edge_mask,
    )


def advance(
    g: GraphSlice,
    frontier: Frontier,
    cond: Optional[Callable[[EdgeView], jnp.ndarray]] = None,
    direction: str = "push",
) -> tuple[Frontier, EdgeView, jnp.ndarray]:
    """Expand the frontier one hop.

    push: active edges are out-edges of frontier vertices; the next frontier
    is the set of destinations whose ``cond`` passed (reference
    ``advance_forward_kernel``, `advance.hxx:21-67`).

    pull: active edges are in-edges of frontier-complement... no — pull here
    matches the reference's ``advance_backward_kernel`` contract
    (`advance.hxx:109-159`): the *caller* passes the unvisited set as the
    frontier and ``cond`` checks the source bitmap; the next frontier is the
    set of frontier vertices with a qualifying in-neighbor.

    Returns (next_frontier, edge_view, active_edge_mask) so callers can run
    further per-edge updates (the apply phase) over the same sweep.
    """
    from mini_tpu.ops.engine import (
        src_bits_to_csc,
        dst_vals_to_csc,
        reduce_csc_by_dst,
    )
    from mini_tpu.utils.profiling import scope

    if direction == "push":
        with scope("advance.push"):
            ev = edges_by_dst(g)  # reduce by dst: CSC order
            # gather-free frontier membership: the bit rides inside the
            # sort key (single-array sort; ops/engine.src_bits_to_csc)
            member = src_bits_to_csc(g, frontier.mask)
            active = member & ev.mask
            if cond is not None:
                active = active & cond(ev)
            nxt = reduce_csc_by_dst(g, active, "or")
            return Frontier(nxt), ev, active
    elif direction == "pull":
        with scope("advance.pull"):
            ev = edges_by_dst(g)
            member = (
                dst_vals_to_csc(g, frontier.mask.astype(jnp.int32)) > 0
            )
            active = member & ev.mask
            if cond is not None:
                active = active & cond(ev)
            nxt = reduce_csc_by_dst(g, active, "or")
            return Frontier(nxt), ev, active
    raise ValueError(f"unknown direction {direction!r}")


def apply_to_dst(
    g: GraphSlice,
    ev: EdgeView,
    active: jnp.ndarray,
    values: jnp.ndarray,
    op: str,
) -> jnp.ndarray:
    """Reduce per-edge ``values`` (masked by ``active``) into per-dst slots.

    The deterministic replacement for the reference's atomic applies
    (atomicCAS label write `bfs/bfs_functor.hxx:30-33`, atomicMin relax
    `sssp/sssp_functor.hxx:20-28`, atomicAdd degree decrement
    `kcore/kcore_functor.hxx:31-35`).
    """
    from mini_tpu.ops.engine import reduce_csc_by_dst
    from mini_tpu.ops.segment import identity_for
    from mini_tpu.utils.profiling import scope

    with scope("apply_to_dst"):
        masked = jnp.where(
            active, values, identity_for(op, values.dtype)
        )
        return reduce_csc_by_dst(g, masked, op)


def filter_frontier(
    frontier: Frontier,
    pred: jnp.ndarray,
) -> Frontier:
    """Keep frontier elements where ``pred`` holds (per-vertex bool array).

    The reference compacts an index list (`filter.hxx:12-31`); on bitmaps the
    same operation is a mask AND — no data movement at all.
    """
    return Frontier(frontier.mask & pred)


def neighborhood_reduce(
    g: GraphSlice,
    frontier: Optional[Frontier],
    value_fn: Callable[[EdgeView], jnp.ndarray],
    op: str = "sum",
    direction: str = "pull",
    identity=None,
) -> jnp.ndarray:
    """Per-frontier-vertex reduction over neighbor values.

    pull (reference ``push=false``): for each frontier vertex v, reduce
    ``value_fn`` over v's in-edges (CSC) — keyed by dst.
    push (reference ``push=true``): reduce over v's out-edges (CSR) — keyed
    by src.  (`neighborhood.hxx:23-58`.)

    ``frontier=None`` means the full vertex set (the common all-vertices
    sweep — PageRank's rank sum, SSSP's relax — skips the membership
    expansion entirely, so routing through this operator costs nothing
    over the raw engine calls).

    Vertices outside the frontier (and zero-degree vertices) receive the
    reduction identity.  Returns a dense [n_pad] array.
    """
    from mini_tpu.ops.engine import (
        dst_vals_to_csc,
        src_vals_to_csr,
        reduce_csc_by_dst,
        reduce_csr_by_src,
    )

    from mini_tpu.utils.profiling import scope

    if direction == "pull":
        ev = edges_by_dst(g)
        reducer = reduce_csc_by_dst
        member_fn = dst_vals_to_csc
    elif direction == "push":
        ev = edges_by_src(g)
        reducer = reduce_csr_by_src
        member_fn = src_vals_to_csr
    else:
        raise ValueError(f"unknown direction {direction!r}")
    with scope(f"neighborhood_reduce.{direction}"):
        vals = value_fn(ev)
        sel = ev.mask
        if frontier is not None:
            sel = sel & (
                member_fn(g, frontier.mask.astype(jnp.int32)) > 0
            )
        masked = jnp.where(sel, vals, identity_for(op, vals.dtype))
        out = reducer(g, masked, op)
        if identity is not None:
            ident = identity_for(op, vals.dtype)
            out = jnp.where(
                out == ident, jnp.asarray(identity, vals.dtype), out
            )
        return out


def compute(
    frontier: Frontier,
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    state: jnp.ndarray,
) -> jnp.ndarray:
    """Per-vertex map applied only on frontier members (design_doc's missing
    ``compute`` operator, `gunrock/design_doc:7`)."""
    return jnp.where(frontier.mask, fn(state), state)
