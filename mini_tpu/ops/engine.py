"""The sorted frontier engine: high-level data-movement helpers used by all
algorithm kernels.

Everything is built from three vector-speed primitives (ops/permute.py):
expansion along the sorted axis, one static-keyed sort for the CSR<->CSC
order switch, and cumsum/scan segmented reductions.  No per-edge XLA
gather/scatter appears anywhere on the hot path (see ops/permute.py).

Edge-order conventions: "csc" = edges sorted by (dst, src) — per-dst
segments contiguous; "csr" = sorted by (src, dst).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mini_tpu.graph.csr import GraphSlice
from mini_tpu.ops.permute import (
    expand_to_edges,
    apply_fixed_perm,
    apply_fixed_perm_bit,
    segmented_scan_reduce,
)
from mini_tpu.ops.segment import contiguous_segment_sum


def _src_vals_to_csc_raw(g: GraphSlice, vertex_vals: jnp.ndarray, *more):
    from mini_tpu.utils.profiling import scope

    with scope("engine.src_to_csc"):
        expanded = [
            expand_to_edges(v, g.row_offsets, g.m_pad)
            for v in (vertex_vals,) + more
        ]
        return apply_fixed_perm(g.csr_to_csc_rank, *expanded)


# --------------------------------------------------------------- autodiff
# The engine's data movers are LINEAR maps, but native autodiff of their
# internals is poor: lax.sort's reverse rule lowers to an m-sized scatter
# by the argsort, and expand_to_edges runs through an int32 bitcast that
# has no sensible cotangent.  Each wrapper below installs the analytic
# transpose built from the SAME forward-style primitives (inverse
# fixed-perm sort + segmented scan reduce), so backward passes cost what
# forwards cost.  Cached per graph so jit retraces reuse one custom_vjp
# instance.
_ENGINE_VJP_CACHE: dict = {}


def _engine_vjp_fns(g: GraphSlice, n_payloads: int):
    # Cache ONLY for concrete graphs: when g's leaves are tracers (the
    # algorithm impls take g as a jit argument), a cached closure would
    # capture one trace's tracers and leak them into a later retrace.
    # Fresh per-trace closures are cheap and trace-local.  A cached
    # closure holds g, so its id stays unique while the entry lives.
    traced = any(
        isinstance(l, jax.core.Tracer)
        for l in jax.tree_util.tree_leaves(g)
    )
    key = (id(g), n_payloads)
    if not traced and key in _ENGINE_VJP_CACHE:
        return _ENGINE_VJP_CACHE[key]

    @jax.custom_vjp
    def s2c(xs):
        return _src_vals_to_csc_raw(g, *xs)

    def s2c_fwd(xs):
        return s2c(xs), None

    def s2c_bwd(_, ct):
        cts = (ct,) if n_payloads == 1 else tuple(ct)
        # transpose of (expand-by-src ∘ csr->csc perm): inverse perm
        # (csc_eids ranks), then sum per src segment — one multi-payload
        # sort + one batched scan, no scatter
        back = apply_fixed_perm(g.csc_eids, *cts)
        if n_payloads == 1:
            return ((reduce_csr_by_src(g, back, "sum"),),)
        stacked = jnp.stack(back, axis=-1)
        red = reduce_csr_by_src(g, stacked, "sum")
        return (tuple(red[..., i] for i in range(n_payloads)),)

    s2c.defvjp(s2c_fwd, s2c_bwd)

    @jax.custom_vjp
    def d2c(x):
        return expand_to_edges(x, g.col_offsets, g.m_pad)

    def d2c_fwd(x):
        return d2c(x), None

    def d2c_bwd(_, ct):
        return (reduce_csc_by_dst(g, ct, "sum"),)

    d2c.defvjp(d2c_fwd, d2c_bwd)

    @jax.custom_vjp
    def rsum(vals):
        return _reduce_csc_by_dst_raw(g, vals, "sum", None)

    def rsum_fwd(vals):
        return rsum(vals), None

    def rsum_bwd(_, ct):
        return (expand_to_edges(ct, g.col_offsets, g.m_pad),)

    rsum.defvjp(rsum_fwd, rsum_bwd)

    fns = (s2c, d2c, rsum)
    if not traced:
        _ENGINE_VJP_CACHE[key] = fns
        while len(_ENGINE_VJP_CACHE) > 64:
            _ENGINE_VJP_CACHE.pop(next(iter(_ENGINE_VJP_CACHE)))
    return fns


def src_vals_to_csc(g: GraphSlice, vertex_vals: jnp.ndarray, *more):
    """per-edge value[src(e)] in CSC order: expand along CSR (sorted by
    src), then switch order with the static-rank sort.  Extra arrays ride
    the same sort as additional payloads.  Differentiable via the analytic
    transpose (see `_engine_vjp_fns`) when every payload is float."""
    vals = (vertex_vals,) + more
    if all(jnp.issubdtype(v.dtype, jnp.floating) for v in vals):
        s2c, _, _ = _engine_vjp_fns(g, len(vals))
        return s2c(vals)
    return _src_vals_to_csc_raw(g, *vals)


def src_bits_to_csc(g: GraphSlice, bits: jnp.ndarray) -> jnp.ndarray:
    """per-edge BOOL value[src(e)] in CSC order, cheaper than
    :func:`src_vals_to_csc`: the bit packs INTO the sort key (one
    single-array sort instead of key+payload — ops/permute.py)."""
    b_csr = expand_to_edges(bits.astype(jnp.int32), g.row_offsets, g.m_pad)
    return apply_fixed_perm_bit(g.csr_to_csc_rank * 2, b_csr) > 0


def dst_vals_to_csc(g: GraphSlice, vertex_vals: jnp.ndarray) -> jnp.ndarray:
    """per-edge value[dst(e)] in CSC order: pure expansion (dst sorted).
    Differentiable via the analytic transpose (segment sum per dst)."""
    from mini_tpu.utils.profiling import scope

    with scope("engine.expand_dst"):
        if jnp.issubdtype(vertex_vals.dtype, jnp.floating):
            _, d2c, _ = _engine_vjp_fns(g, 1)
            return d2c(vertex_vals)
        return expand_to_edges(vertex_vals, g.col_offsets, g.m_pad)


def src_vals_to_csr(g: GraphSlice, vertex_vals: jnp.ndarray) -> jnp.ndarray:
    """per-edge value[src(e)] in CSR order: pure expansion (src sorted)."""
    return expand_to_edges(vertex_vals, g.row_offsets, g.m_pad)


def dst_vals_to_csr(g: GraphSlice, vertex_vals: jnp.ndarray, *more):
    """per-edge value[dst(e)] in CSR order: expand along CSC, then switch
    with the inverse rank (csc_eids = CSR position of each CSC edge)."""
    expanded = [
        expand_to_edges(v, g.col_offsets, g.m_pad)
        for v in (vertex_vals,) + more
    ]
    return apply_fixed_perm(g.csc_eids, *expanded)


def reduce_csc_by_dst(
    g: GraphSlice,
    edge_vals: jnp.ndarray,
    op: str,
    identity=None,
) -> jnp.ndarray:
    """Segmented reduce of CSC-ordered per-edge values into [n_pad] dst
    slots: or/and/int-sum via cumsum-difference, min/max/float-sum via one
    associative scan.  Float ``sum`` is differentiable via the analytic
    transpose (expansion per dst)."""
    if (
        op == "sum"
        and identity is None
        and jnp.issubdtype(edge_vals.dtype, jnp.floating)
    ):
        _, _, rsum = _engine_vjp_fns(g, 1)
        return rsum(edge_vals)
    return _reduce_csc_by_dst_raw(g, edge_vals, op, identity)


def _reduce_csc_by_dst_raw(
    g: GraphSlice,
    edge_vals: jnp.ndarray,
    op: str,
    identity=None,
) -> jnp.ndarray:
    if op == "or":
        s = contiguous_segment_sum(
            edge_vals.astype(jnp.int32), g.col_offsets
        )
        return s > 0
    if op == "sum" and jnp.issubdtype(edge_vals.dtype, jnp.integer):
        return contiguous_segment_sum(edge_vals, g.col_offsets)
    from mini_tpu.ops.segment import identity_for

    ident = (
        identity_for(op if op != "sum" else "sum", edge_vals.dtype)
        if identity is None
        else jnp.asarray(identity, edge_vals.dtype)
    )
    from mini_tpu.utils.profiling import scope

    with scope(f"engine.segreduce_dst.{op}"):
        return segmented_scan_reduce(
            edge_vals, g.csc_dsts, g.col_offsets, op, ident,
            max_seg_len=g.max_in_degree,
        )


def reduce_csr_by_src(
    g: GraphSlice,
    edge_vals: jnp.ndarray,
    op: str,
    identity=None,
) -> jnp.ndarray:
    if op == "or":
        s = contiguous_segment_sum(
            edge_vals.astype(jnp.int32), g.row_offsets
        )
        return s > 0
    if op == "sum" and jnp.issubdtype(edge_vals.dtype, jnp.integer):
        return contiguous_segment_sum(edge_vals, g.row_offsets)
    from mini_tpu.ops.segment import identity_for

    ident = (
        identity_for(op if op != "sum" else "sum", edge_vals.dtype)
        if identity is None
        else jnp.asarray(identity, edge_vals.dtype)
    )
    return segmented_scan_reduce(
        edge_vals, g.csr_srcs, g.row_offsets, op, ident,
        max_seg_len=g.max_out_degree,
    )
