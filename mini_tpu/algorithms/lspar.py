"""L-Spar local-similarity graph sparsification (one-shot pipeline).

Reference recipe (`/root/reference/gunrock/src/lspar/lspar_enactor.hxx:49-111`):
(1) neighborhood min-reduce of universal-hash vertex hashes -> per-vertex
minwise hash; (2) advance writes per-edge sim = (minhash[src]==minhash[dst]);
(3) moderngpu ``segmented_sort`` orders each vertex's adjacency by sim
descending; (4) advance tags the top-⌊deg^e⌋ edges per vertex;
(5) ``transform_compact`` gathers the selected edges.

Design: no sort and no per-edge gather at all.  Similarities are
binary, so an edge's rank under the stable (sim descending) segmented sort
is a PREFIX COUNT: ``sim==1`` edges rank by the number of earlier sim-1
edges in their segment, ``sim==0`` edges by (segment's sim-1 total + number
of earlier sim-0 edges) — all computable from one global cumsum of sims
plus per-vertex boundary reads (n-sized, cheap).  Per-edge hash/minwise
values move via the gather-free engine (expansion + the static CSR<->CSC
permutation); the tag+compact steps are a mask in native CSR order, so the
reference's final ``transform_compact`` scatter disappears too.  The
universal hash family ``(b + a*i) mod p`` and the host-side primality
check match the reference (`lspar/lspar_problem.hxx:58-93`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.engine import dst_vals_to_csr, reduce_csr_by_src
from mini_tpu.ops.permute import expand_to_edges


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LsparResult:
    selected_mask: jnp.ndarray  # bool[m_pad] over CSR edge ids
    sims: jnp.ndarray  # int32[m_pad]: per-edge minhash similarity (CSR order)
    num_selected: jnp.ndarray  # int32


def is_prime(number: int) -> bool:
    """Host-side primality test (reference `lspar/lspar_problem.hxx:80-89`)."""
    if number < 2:
        return False
    if number in (2, 3):
        return True
    if number % 2 == 0 or number % 3 == 0:
        return False
    k = 1
    while 36 * k * k - 12 * k < number:
        if number % (6 * k + 1) == 0 or number % (6 * k - 1) == 0:
            return False
        k += 1
    return True


@jax.jit
def _lspar_impl(g: GraphSlice, hashs, thresholds):
    m_pad = g.m_pad
    emask = g.edge_mask
    INT_MAX = jnp.iinfo(jnp.int32).max

    # (1) minwise hash over out-neighbors: hash[dst] per CSR edge rides
    # the engine (expansion + the one static permutation), masked min
    hash_dst_e = dst_vals_to_csr(g, hashs)
    minwise = reduce_csr_by_src(
        g, jnp.where(emask, hash_dst_e, INT_MAX), "min"
    )
    # (2) per-edge similarity: minwise[src] is a pure expansion,
    # minwise[dst] one more permutation
    mw_src_e = expand_to_edges(minwise, g.row_offsets, m_pad)
    mw_dst_e = dst_vals_to_csr(g, minwise)
    sims = (emask & (mw_src_e == mw_dst_e)).astype(jnp.int32)

    # (3+4+5) stable (src, sim desc) rank WITHOUT sorting: with binary
    # sims the sorted rank is a prefix count.  One global cumsum gives
    # sim-1 prefix counts; per-vertex boundary reads (n-sized gathers are
    # cheap) give each segment's start offsets and sim-1 totals.
    c1 = jnp.cumsum(sims)  # inclusive prefix of sim-1 edges
    c1_ext = jnp.concatenate([jnp.zeros(1, jnp.int32), c1])
    off = g.row_offsets.astype(jnp.int32)
    start_c1 = c1_ext[off[:-1]]  # sim-1 edges before each segment
    n1 = c1_ext[off[1:]] - start_c1  # sim-1 edges per segment
    p1 = (c1 - sims) - expand_to_edges(start_c1, g.row_offsets, m_pad)
    local = jnp.arange(m_pad, dtype=jnp.int32) - expand_to_edges(
        off[:-1], g.row_offsets, m_pad
    )
    rank_sorted = jnp.where(
        sims == 1, p1, expand_to_edges(n1, g.row_offsets, m_pad)
        + (local - p1)
    )
    thr_e = expand_to_edges(thresholds, g.row_offsets, m_pad)
    selected = (rank_sorted < thr_e) & emask
    return LsparResult(
        selected_mask=selected,
        sims=sims,
        num_selected=jnp.sum(selected.astype(jnp.int32)),
    )


def lspar(
    g: GraphSlice,
    prime: int = 999983,
    e: float = 0.5,
    seed: int = 0,
) -> LsparResult:
    if not is_prime(prime):
        raise ValueError(f"{prime} is not prime")
    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)  # params as in `lspar/lspar_problem.hxx:95-99`
    b = rng.randint(0, prime)
    idx = np.arange(g.n_pad, dtype=np.int64)
    hashs = jnp.asarray(((b + a * idx) % prime).astype(np.int32))
    deg = np.asarray(g.out_degrees).astype(np.float64)
    thresholds = jnp.asarray(
        np.floor(np.power(deg, e)).astype(np.int32)
    )  # ⌊deg^e⌋, `lspar/lspar_problem.hxx:58-63`
    return _lspar_impl(g, hashs, thresholds)


def lspar_cpu(
    hg: HostGraph, hashs: np.ndarray, e: float
) -> tuple[np.ndarray, int]:
    """NumPy oracle (the reference ships none — `tests/lspar/test_lspar.cu:37-39`
    prints the count only).  Returns (selected bool[m] over CSR edges, count).
    """
    minwise = np.full(hg.n, np.iinfo(np.int32).max, dtype=np.int64)
    np.minimum.at(minwise, hg.csr_srcs, hashs[hg.csr_dsts])
    sims = (minwise[hg.csr_srcs] == minwise[hg.csr_dsts]).astype(np.int32)
    thres = np.floor(np.power(hg.out_degrees.astype(np.float64), e)).astype(
        np.int64
    )
    selected = np.zeros(hg.m, dtype=bool)
    for v in range(hg.n):
        lo, hi = hg.row_offsets[v], hg.row_offsets[v + 1]
        seg = np.arange(lo, hi)
        order = seg[np.argsort(-sims[lo:hi], kind="stable")]
        selected[order[: thres[v]]] = True
    return selected, int(selected.sum())
