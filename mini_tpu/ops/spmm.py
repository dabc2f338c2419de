"""SpMM and SDDMM over the graph slice — the feature-valued generalization of
neighborhood-reduce (cf. `/root/reference/gunrock/src/neighborhood.hxx:13-70`,
whose scalar ``Value`` reduce is the F=1 special case), powering both
PageRank-style rank aggregation and GNN message passing.

Both are gather + sorted segment reduce in plain XLA, differentiable by
autodiff.  For direction="pull":
    out[v, :] = sum_{e=(u,v) in E} w[e] * X[u, :]
and for direction="push":
    out[u, :] = sum_{e=(u,v) in E} w[e] * X[v, :]
The m x F message stream ``X[gather ids] * w`` is not materialized on an
H100: XLA fuses the gather and scale into the scatter-add (the compiled
pull SpMM at F=128 on 134M edges needs no temporary buffer).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from mini_tpu.graph.csr import GraphSlice
from mini_tpu.ops.segment import segment_reduce


def spmm(
    g: GraphSlice,
    x: jnp.ndarray,
    direction: str = "pull",
    weights: Optional[jnp.ndarray] = None,
    op: str = "sum",
    heads: int = 1,
) -> jnp.ndarray:
    """Sparse (adjacency) times dense (features): [n_pad, F] -> [n_pad, F].

    ``weights`` overrides the graph's edge weights; it must be in the edge
    order of the chosen direction (CSC for pull, CSR for push).

    ``heads > 1`` is the blockwise multi-head form (GAT): x is the head
    CONCAT [n_pad, H*d], weights is [m_pad, H], and head h's feature block
    is scaled by its own per-edge weight column —

        out[v, h*d:(h+1)*d] = sum_e w[e, h] * x[src e, h*d:(h+1)*d]

    — so all heads ride one gather and one segment reduce instead of H.
    """
    if x.ndim == 1:
        return spmm(
            g, x[:, None], direction=direction, weights=weights, op=op,
        )[:, 0]
    if heads > 1:
        assert weights is not None and weights.ndim == 2
        assert x.shape[-1] % heads == 0

    if direction == "pull":
        seg, gather_ids = g.csc_dsts, g.csc_srcs
        w = g.csc_weights if weights is None else weights
        mask = g.edge_mask_csc
    elif direction == "push":
        seg, gather_ids = g.csr_srcs, g.csr_dsts
        w = g.csr_weights if weights is None else weights
        mask = g.edge_mask
    else:
        raise ValueError(f"unknown direction {direction!r}")

    if heads > 1:
        m, F = gather_ids.shape[0], x.shape[-1]
        msgs = (
            x[gather_ids].reshape(m, heads, F // heads)
            * w[:, :, None].astype(x.dtype)
        ).reshape(m, F)
    else:
        msgs = x[gather_ids] * w[:, None].astype(x.dtype)
    return segment_reduce(msgs, seg, g.n_pad, op, mask=mask[:, None])


def sddmm(
    g: GraphSlice,
    xl: jnp.ndarray,
    xr: Optional[jnp.ndarray] = None,
    order: str = "csr",
) -> jnp.ndarray:
    """Sampled dense-dense product: per-edge <xl[src], xr[dst]> over the
    sparsity pattern — the shape of L-Spar's per-edge similarity step
    (`lspar/lspar_functor.hxx:28-33`) and of GNN edge scoring.

    Returns float[m_pad] in the requested edge order.
    """
    xr = xl if xr is None else xr
    if order == "csr":
        src, dst, mask = g.csr_srcs, g.csr_dsts, g.edge_mask
    elif order == "csc":
        src, dst, mask = g.csc_srcs, g.csc_dsts, g.edge_mask_csc
    else:
        raise ValueError(f"unknown order {order!r}")
    if xl.ndim == 1:
        vals = xl[src] * xr[dst]
    else:
        vals = jnp.sum(xl[src] * xr[dst], axis=-1)
    return jnp.where(mask, vals, 0)
