"""PageRank via neighborhood-reduce (the SpMV/SpMM path).

Reference recipe (`/root/reference/gunrock/src/pr/pr_enactor.hxx:41-79`):
``neighborhood_kernel(pull, plus)`` sums in-neighbor ranks, then a filter
applies ``rank = 0.15 + 0.85 * reduced / out_degree`` and keeps vertices
whose rank moved more than 0.1% (`pr/pr_functor.hxx:11-17`).

Two variants:

* ``variant="mini"`` — parity with the reference *semantics* (sum of raw
  in-neighbor ranks divided by the vertex's own out-degree; converged
  vertices freeze but keep contributing).  The reference's frontier/segment
  index misalignment after iteration 0 (`pr/pr_functor.hxx:13` vs
  `neighborhood.hxx:58`, see SURVEY.md §2.2) is a bug, not a behavior — we
  index by vertex id.
* ``variant="standard"`` — textbook PageRank: each neighbor contributes
  ``rank[u] / out_degree[u]``, update ``(1-d)/n + d * sum``; this is the
  numerically meaningful one and the benchmark config
  ("neighborhood-reduce PageRank").

Both run as one SpMV per iteration under ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.engine import src_vals_to_csc, reduce_csc_by_dst


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PageRankResult:
    ranks: jnp.ndarray  # float32[n_pad]
    num_iterations: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _pagerank_impl(
    g: GraphSlice,
    variant: str,
    damping: float,
    tol_rel: float,
    max_iter: int,
):
    n_pad = g.n_pad
    real = jnp.arange(n_pad) < g.n
    out_deg = g.out_degrees.astype(jnp.float32)
    # PR sums raw neighbor ranks — adjacency structure only, never edge
    # weights (reference `pr/pr_functor.hxx:27-29` reduces d_current_ranks);
    # the gather-free sweep expands ranks by src and reduces by dst.

    if variant == "mini":
        ranks0 = jnp.where(real, 0.15, 0.0).astype(jnp.float32)
    else:
        ranks0 = jnp.where(real, 1.0 / g.n, 0.0).astype(jnp.float32)
    active0 = real

    from mini_tpu.ops.operators import neighborhood_reduce

    def _nbr_sum(vertex_vals):
        # the reference's neighborhood_kernel(pull, plus) shape
        # (`pr/pr_enactor.hxx:53`) through the operator layer
        return neighborhood_reduce(
            g, None, lambda ev: src_vals_to_csc(g, vertex_vals),
            op="sum", direction="pull",
        )

    def step(state):
        ranks, active, it = state
        if variant == "mini":
            reduced = _nbr_sum(jnp.where(real, ranks, 0.0))
            new = jnp.where(
                out_deg > 0, 0.15 + damping * reduced / out_deg, 0.15
            )
            new = jnp.where(jnp.isfinite(new), new, 0.0)
        else:
            contrib = jnp.where(out_deg > 0, ranks / out_deg, 0.0)
            reduced = _nbr_sum(contrib)
            # dangling mass redistributed uniformly
            dangling = jnp.sum(jnp.where(real & (out_deg == 0), ranks, 0.0))
            new = (1.0 - damping) / g.n + damping * (
                reduced + dangling / g.n
            )
        new = jnp.where(real, new, 0.0)
        # converged vertices freeze (reference filter semantics,
        # `pr/pr_functor.hxx:11-17`)
        new = jnp.where(active, new, ranks)
        moved = jnp.abs(new - ranks) > tol_rel * jnp.abs(ranks)
        return new, active & moved & real, it + 1

    def cond(state):
        _, active, it = state
        return jnp.any(active) & (it < max_iter)

    ranks, _, it = jax.lax.while_loop(
        cond, step, (ranks0, active0, jnp.int32(0))
    )
    return PageRankResult(ranks, it)


def pagerank(
    g: GraphSlice,
    variant: str = "standard",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
) -> PageRankResult:
    return _pagerank_impl(
        g, variant, float(damping), float(tol_rel), int(max_iter)
    )


def pagerank_cpu(
    hg: HostGraph,
    variant: str = "standard",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
) -> np.ndarray:
    """NumPy oracle mirroring the device iteration (the reference ships no
    PR oracle — `tests/pr/test_pr.cu:39-40` prints top-10 only).

    Sparse (edge-list bincount) aggregation so validation works at
    rmat16+ scales — the earlier dense n x n multiplier needed 34 GB at
    n=65k.  Multi-edges contribute multiplicity, same as the dense form.
    """
    n = hg.n
    out_deg = hg.out_degrees.astype(np.float64)
    src, dst = hg.csr_srcs, hg.csr_dsts

    def pull_sum(vals: np.ndarray) -> np.ndarray:
        return np.bincount(dst, weights=vals[src], minlength=n)

    ranks = np.full(n, 0.15 if variant == "mini" else 1.0 / n)
    active = np.ones(n, dtype=bool)
    for _ in range(max_iter):
        if not active.any():
            break
        if variant == "mini":
            reduced = pull_sum(ranks)
            new = np.where(
                out_deg > 0, 0.15 + damping * reduced / np.maximum(out_deg, 1),
                0.15,
            )
        else:
            contrib = np.where(out_deg > 0, ranks / np.maximum(out_deg, 1), 0)
            reduced = pull_sum(contrib)
            dangling = ranks[out_deg == 0].sum()
            new = (1 - damping) / n + damping * (reduced + dangling / n)
        new = np.where(active, new, ranks)
        moved = np.abs(new - ranks) > tol_rel * np.abs(ranks)
        ranks, active = new, active & moved
    return ranks.astype(np.float32)
