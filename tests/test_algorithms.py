"""End-to-end algorithm tests against CPU oracles (the reference's
oracle-in-problem pattern, SURVEY.md §4 — extended to the three primitives
the reference leaves unvalidated: PR, coloring, L-Spar)."""

import numpy as np
import pytest

from mini_tpu.graph import GraphSlice, erdos_renyi, rmat
from mini_tpu.algorithms import (
    bfs,
    bfs_cpu,
    validate_preds,
    sssp,
    sssp_cpu,
    validate_pred_tree,
    pagerank,
    pagerank_cpu,
    coloring,
    validate_coloring,
    kcore,
    kcore_cpu,
    kcore_cpu_true,
    lspar,
    lspar_cpu,
    is_prime,
)


# ----------------------------------------------------------------------- BFS
def test_bfs_tiny(tiny_graph, tiny_slice):
    res = bfs(tiny_slice, src=0)
    expected = bfs_cpu(tiny_graph, 0)
    got = np.asarray(res.labels)[: tiny_graph.n]
    np.testing.assert_array_equal(got, expected)  # bitwise
    assert validate_preds(got, np.asarray(res.preds), tiny_graph, 0)


@pytest.mark.parametrize("src", [0, 17, 123])
def test_bfs_random(random_graph, random_slice, src):
    res = bfs(random_slice, src=src)
    expected = bfs_cpu(random_graph, src)
    got = np.asarray(res.labels)[: random_graph.n]
    np.testing.assert_array_equal(got, expected)
    assert validate_preds(got, np.asarray(res.preds), random_graph, src)
    # ghost vertices stay unvisited
    assert np.all(np.asarray(res.labels)[random_graph.n:] == -1)


def test_validate_preds_rejects_broken_trees(random_graph, random_slice):
    res = bfs(random_slice, src=0)
    labels = np.asarray(res.labels)[: random_graph.n]
    preds = np.asarray(res.preds)[: random_graph.n].copy()
    assert validate_preds(labels, preds, random_graph, 0)
    deep = int(np.flatnonzero(labels == labels.max())[0])
    # a parent two levels up, or one level up but not adjacent, or none
    hg = random_graph
    nbrs = set(hg.csr_dsts[hg.row_offsets[deep]: hg.row_offsets[deep + 1]])
    up = np.flatnonzero(labels == labels[deep] - 1)
    far = [int(u) for u in up if u not in nbrs and deep not in set(
        hg.csr_dsts[hg.row_offsets[u]: hg.row_offsets[u + 1]])]
    bad_parents = [int(np.flatnonzero(labels == 0)[0]), -1] + far[:1]
    for p in bad_parents:
        broken = preds.copy()
        broken[deep] = p
        assert not validate_preds(labels, broken, random_graph, 0), p


def test_bfs_directed(random_directed_graph, random_directed_slice):
    res = bfs(random_directed_slice, src=3)
    expected = bfs_cpu(random_directed_graph, 3)
    np.testing.assert_array_equal(
        np.asarray(res.labels)[: random_directed_graph.n], expected
    )


def test_bfs_disconnected():
    hg = erdos_renyi(64, 100, seed=9, undirected=True)
    # add isolated vertices by declaring extra nodes
    from mini_tpu.graph import from_edges

    hg2 = from_edges(
        hg.csr_srcs, hg.csr_dsts, hg.csr_weights, num_nodes=80
    )
    gs = GraphSlice.from_host(hg2)
    res = bfs(gs, src=0)
    expected = bfs_cpu(hg2, 0)
    np.testing.assert_array_equal(np.asarray(res.labels)[:80], expected)
    assert (expected == -1).any()  # isolated vertices really are unreachable


def test_bfs_alpha_triggers_pull_accounting(random_slice):
    res_pushy = bfs(random_slice, src=0, alpha=0.0)
    res_pully = bfs(random_slice, src=0, alpha=1e9)
    # direction choice must not change results
    np.testing.assert_array_equal(
        np.asarray(res_pushy.labels), np.asarray(res_pully.labels)
    )
    assert int(res_pushy.num_pull_iterations) == 0
    assert int(res_pully.num_pull_iterations) == int(
        res_pully.num_iterations
    )


# ---------------------------------------------------------------------- SSSP
@pytest.mark.parametrize("src", [0, 42])
def test_sssp_random_bitwise(random_graph, random_slice, src):
    res = sssp(random_slice, src=src)
    exp_dist, _ = sssp_cpu(random_graph, src)
    got = np.asarray(res.dists)[: random_graph.n]
    # bitwise: both paths compute f32 min over identical f32 sums
    np.testing.assert_array_equal(got, exp_dist)
    assert validate_pred_tree(got, np.asarray(res.preds), random_graph, src)


def test_sssp_directed(random_directed_graph, random_directed_slice):
    res = sssp(random_directed_slice, src=1)
    exp_dist, _ = sssp_cpu(random_directed_graph, 1)
    np.testing.assert_array_equal(
        np.asarray(res.dists)[: random_directed_graph.n], exp_dist
    )


def test_sssp_unreachable():
    from mini_tpu.graph import from_edges

    hg = from_edges([0, 1], [1, 0], num_nodes=4)
    gs = GraphSlice.from_host(hg)
    res = sssp(gs, src=0)
    d = np.asarray(res.dists)
    assert d[1] == 1.0 and np.isinf(d[2]) and np.isinf(d[3])


# ------------------------------------------------------------------ PageRank
@pytest.mark.parametrize("variant", ["standard", "mini"])
def test_pagerank_matches_oracle(random_graph, random_slice, variant):
    res = pagerank(random_slice, variant=variant, max_iter=30)
    expected = pagerank_cpu(random_graph, variant=variant, max_iter=30)
    got = np.asarray(res.ranks)[: random_graph.n]
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-6)


def test_pagerank_standard_sums_to_one(random_slice, random_graph):
    res = pagerank(random_slice, variant="standard", tol_rel=1e-7,
                   max_iter=200)
    total = float(np.asarray(res.ranks).sum())
    assert abs(total - 1.0) < 1e-3


# ------------------------------------------------------------------ Coloring
def test_coloring_proper(random_graph, random_slice):
    res = coloring(random_slice, seed=1)
    colors = np.asarray(res.colors)
    assert validate_coloring(colors, random_graph)
    assert np.all(colors[random_graph.n:] == 0)  # ghosts untouched


def test_coloring_tiny(tiny_graph, tiny_slice):
    res = coloring(tiny_slice, seed=0)
    assert validate_coloring(np.asarray(res.colors), tiny_graph)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_coloring_hashes_per_round_proper(random_graph, random_slice, k):
    res = coloring(random_slice, seed=2, hashes_per_round=k)
    assert validate_coloring(np.asarray(res.colors), random_graph)


def test_coloring_generic_k_path_matches_fast(random_graph, random_slice):
    """The generic (sort-based) K>1 path — used when the fast path's
    in/out slot equivalence doesn't hold — stays proper and agrees with
    the fast path on round count order of magnitude."""
    import jax as _jax
    from mini_tpu.algorithms.coloring import _coloring_impl

    res = _coloring_impl(
        random_slice, _jax.random.PRNGKey(2), 1000003,
        2 * random_graph.n, 8,
    )
    assert validate_coloring(np.asarray(res.colors), random_graph)


def test_coloring_more_hashes_fewer_rounds(random_graph, random_slice):
    r1 = coloring(random_slice, seed=3, hashes_per_round=1)
    r8 = coloring(random_slice, seed=3, hashes_per_round=8)
    assert int(r8.num_iterations) < int(r1.num_iterations)
    assert validate_coloring(np.asarray(r8.colors), random_graph)


# -------------------------------------------------------------------- k-core
def test_kcore_tiny(tiny_graph, tiny_slice):
    res = kcore(tiny_slice, variant="mini")
    exp_cores, exp_largest = kcore_cpu(tiny_graph)
    np.testing.assert_array_equal(
        np.asarray(res.num_cores)[: tiny_graph.n], exp_cores
    )
    assert int(res.largest_k_core) == exp_largest


def test_kcore_random(random_graph, random_slice):
    res = kcore(random_slice, variant="mini")
    exp_cores, exp_largest = kcore_cpu(random_graph)
    np.testing.assert_array_equal(
        np.asarray(res.num_cores)[: random_graph.n], exp_cores
    )
    assert int(res.largest_k_core) == exp_largest


def test_kcore_reference_fixture():
    """The reference's kcore fixture graph
    (/root/reference/gunrock/tests/kcore/test_kcore.mtx: 9 nodes, 34 edges,
    loaded undirected -> doubled)."""
    from mini_tpu.graph import from_edges

    edges = [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4), (4, 5),
        (4, 6), (5, 6), (2, 5), (1, 6), (0, 7), (7, 8), (5, 8), (0, 8),
        (8, 2),
    ]
    srcs, dsts = zip(*edges)
    hg = from_edges(
        np.array(srcs), np.array(dsts), num_nodes=9, make_undirected=True
    )
    gs = GraphSlice.from_host(hg)
    res = kcore(gs, variant="mini")
    exp_cores, exp_largest = kcore_cpu(hg)
    np.testing.assert_array_equal(
        np.asarray(res.num_cores)[: hg.n], exp_cores
    )
    assert int(res.largest_k_core) == exp_largest


def test_kcore_hindex_true_cores_random_multigraphs():
    """h-index fixpoint == true coreness on undirected multigraphs
    (incl. parallel edges and self-loops), against the live-degree
    peeling oracle."""
    from mini_tpu.graph import from_edges

    rng = np.random.RandomState(11)
    for _ in range(8):
        n = rng.randint(3, 40)
        m = rng.randint(1, 150)
        hg = from_edges(
            rng.randint(0, n, m),
            rng.randint(0, n, m),
            num_nodes=n,
            make_undirected=True,
        )
        gs = GraphSlice.from_host(hg)
        res = kcore(gs, variant="hindex")
        exp_cores, exp_largest = kcore_cpu_true(hg)
        np.testing.assert_array_equal(
            np.asarray(res.num_cores)[: hg.n], exp_cores
        )
        assert int(res.largest_k_core) == exp_largest


def test_kcore_auto_picks_hindex_for_undirected(random_graph, random_slice):
    res = kcore(random_slice)  # auto -> hindex (fixture is undirected)
    exp_cores, exp_largest = kcore_cpu_true(random_graph)
    np.testing.assert_array_equal(
        np.asarray(res.num_cores)[: random_graph.n], exp_cores
    )
    assert int(res.largest_k_core) == exp_largest


def test_kcore_hindex_rejects_directed(random_directed_slice):
    with pytest.raises(ValueError):
        kcore(random_directed_slice, variant="hindex")


def test_kcore_semantics_divergence_documented():
    """The reference peel semantics rob a vertex of its core number when
    parallel-edge decrements drive its degree past 0; the hindex variant
    reports the true coreness.  Pin one such case so the divergence stays
    deliberate."""
    from mini_tpu.graph import from_edges

    # v0 -- v1 triple edge, plus v1-v2: peeling v2 at k=2 leaves v1 at
    # deg 3; peeling v1's side at k=4 drops v0 by 3 in one round: 3 -> 0,
    # never satisfying 0 < deg < k with deg > 0 afterwards.
    s = np.array([0, 0, 0, 1, 2])
    d = np.array([1, 1, 1, 2, 3])
    hg = from_edges(s, d, num_nodes=4, make_undirected=True)
    mini_cores, _ = kcore_cpu(hg)
    true_cores, _ = kcore_cpu_true(hg)
    gs = GraphSlice.from_host(hg)
    np.testing.assert_array_equal(
        np.asarray(kcore(gs, variant="mini").num_cores)[: hg.n], mini_cores
    )
    np.testing.assert_array_equal(
        np.asarray(kcore(gs, variant="hindex").num_cores)[: hg.n],
        true_cores,
    )


# --------------------------------------------------------------------- L-Spar
def test_is_prime():
    assert is_prime(2) and is_prime(3) and is_prime(999983)
    assert not is_prime(1) and not is_prime(999981) and not is_prime(4)


def test_lspar_matches_oracle(random_graph, random_slice):
    prime, e, seed = 999983, 0.5, 0
    res = lspar(random_slice, prime=prime, e=e, seed=seed)
    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)
    b = rng.randint(0, prime)
    hashs = ((b + a * np.arange(random_slice.n_pad, dtype=np.int64)) % prime
             ).astype(np.int32)
    exp_sel, exp_count = lspar_cpu(random_graph, hashs, e)
    assert int(res.num_selected) == exp_count
    # per-vertex selected counts must match (edge choice within equal-sim
    # ties may differ between stable sorts, counts may not)
    got_sel = np.asarray(res.selected_mask)[: random_graph.m]
    got_counts = np.bincount(
        random_graph.csr_srcs[got_sel], minlength=random_graph.n
    )
    exp_counts = np.bincount(
        random_graph.csr_srcs[exp_sel], minlength=random_graph.n
    )
    np.testing.assert_array_equal(got_counts, exp_counts)
    # every selected edge with sim=0 implies no unselected sim=1 edge exists
    # in the same segment (top-by-sim property)
    sims = np.asarray(res.sims)[: random_graph.m]
    for v in range(random_graph.n):
        lo, hi = random_graph.row_offsets[v], random_graph.row_offsets[v + 1]
        seg_sel = got_sel[lo:hi]
        seg_sim = sims[lo:hi]
        if seg_sel.any() and (~seg_sel).any():
            assert seg_sim[seg_sel].min() >= seg_sim[~seg_sel].max()


def test_lspar_rejects_composite_prime(random_slice):
    with pytest.raises(ValueError):
        lspar(random_slice, prime=1000)


# ------------------------------------------------------- connected components
def test_cc_matches_union_find(random_graph, random_slice):
    from mini_tpu.algorithms import connected_components, cc_cpu

    res = connected_components(random_slice)
    expected = cc_cpu(random_graph)
    np.testing.assert_array_equal(
        np.asarray(res.components)[: random_graph.n], expected
    )
    assert int(res.num_components) == len(np.unique(expected))


def test_cc_disconnected_blocks():
    from mini_tpu.graph import from_edges, GraphSlice
    from mini_tpu.algorithms import connected_components, cc_cpu

    # 3 disjoint triangles + 2 isolated vertices
    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3),
             (6, 7), (7, 8), (8, 6)]
    srcs, dsts = zip(*edges)
    hg = from_edges(np.array(srcs), np.array(dsts), num_nodes=11,
                    make_undirected=True)
    gs = GraphSlice.from_host(hg)
    res = connected_components(gs)
    expected = cc_cpu(hg)
    np.testing.assert_array_equal(
        np.asarray(res.components)[:11], expected
    )
    assert int(res.num_components) == 5


# ------------------------------------------------------------ batched sources
def test_bfs_batch_matches_single(random_graph, random_slice):
    from mini_tpu.algorithms import bfs_batch

    srcs = [0, 17, 123]
    res = bfs_batch(random_slice, srcs)
    assert res.labels.shape[0] == len(srcs)
    for i, s in enumerate(srcs):
        single = bfs(random_slice, src=s)
        np.testing.assert_array_equal(  # bitwise vs the single-src program
            np.asarray(res.labels)[i], np.asarray(single.labels)
        )
        np.testing.assert_array_equal(
            np.asarray(res.preds)[i], np.asarray(single.preds)
        )
    assert not np.any(np.asarray(res.sparse_overflowed))


def test_sssp_batch_matches_single(random_graph, random_slice):
    from mini_tpu.algorithms import sssp_batch

    srcs = [0, 5]
    res = sssp_batch(random_slice, srcs)
    for i, s in enumerate(srcs):
        single = sssp(random_slice, src=s)
        np.testing.assert_array_equal(  # bitwise (f32 min is exact)
            np.asarray(res.dists)[i], np.asarray(single.dists)
        )
    assert not np.any(np.asarray(res.sparse_overflowed))


def test_sssp_batch_variant_and_no_preds(random_graph, random_slice):
    # --sources previously dropped the delta variant; and the batch form
    # gains bfs_batch's with_preds escape hatch
    from mini_tpu.algorithms import sssp_batch

    srcs = [0, 17]
    res = sssp_batch(random_slice, srcs, variant="delta")
    for i, s in enumerate(srcs):
        single = sssp(random_slice, src=s, variant="delta")
        np.testing.assert_array_equal(
            np.asarray(res.dists)[i], np.asarray(single.dists)
        )
    lean = sssp_batch(random_slice, srcs, with_preds=False)
    np.testing.assert_array_equal(  # dists unaffected by skipping preds
        np.asarray(lean.dists), np.asarray(sssp_batch(random_slice, srcs).dists)
    )
    assert np.all(np.asarray(lean.preds) == -1)


def test_sssp_auto_variant_picks_and_matches():
    # auto = degree proxy: grid (deg ~4) -> delta, rmat (deg ~16) -> bellman
    from mini_tpu.graph import grid2d
    from mini_tpu.algorithms.sssp import _auto_variant

    hg_grid = grid2d(12, 12, seed=3, weighted=True)
    gs_grid = GraphSlice.from_host(hg_grid)
    assert _auto_variant(gs_grid) == "delta"
    hg_rmat = rmat(8, edge_factor=16, seed=3, weighted=True)
    assert _auto_variant(GraphSlice.from_host(hg_rmat)) == "bellman"
    res = sssp(gs_grid, src=0, variant="auto")
    exp, _ = sssp_cpu(hg_grid, 0)
    np.testing.assert_array_equal(
        np.asarray(res.dists)[: hg_grid.n], exp
    )


def test_sparse_overflow_flag_stays_false(random_graph, random_slice):
    # capacity-fit tier selection must never overflow
    res = bfs(random_slice, src=0)
    assert not bool(res.sparse_overflowed)
    res2 = sssp(random_slice, src=0)
    assert not bool(res2.sparse_overflowed)


def test_sssp_delta_stepping_matches_oracle(random_graph, random_slice):
    from mini_tpu.algorithms import sssp as _sssp

    for src in (0, 17):
        res = _sssp(random_slice, src=src, variant="delta")
        exp, _ = sssp_cpu(random_graph, src)
        np.testing.assert_array_equal(  # bitwise (f32 min fixpoint)
            np.asarray(res.dists)[: random_graph.n], exp
        )
        assert not bool(res.sparse_overflowed)
        assert validate_pred_tree(
            np.asarray(res.dists)[: random_graph.n],
            np.asarray(res.preds), random_graph, src,
        )


def test_sssp_retrace_same_graph_different_static_args():
    # regression: cached engine custom-VJP closures must not capture one
    # trace's tracers and leak them into a retrace on the same graph
    # (different static delta)
    from mini_tpu.graph import grid2d

    hg = grid2d(16, 16, seed=0, weighted=True)
    gs = GraphSlice.from_host(hg)
    exp, _ = sssp_cpu(hg, 0)
    for kwargs in (
        {"variant": "delta", "delta": 8.0},
        {"variant": "delta", "delta": 32.0},
        {},
    ):
        r = sssp(gs, 0, **kwargs)
        np.testing.assert_array_equal(np.asarray(r.dists)[: hg.n], exp)


def test_sssp_delta_chained_rounds_match_oracle():
    # round-5 compact chaining: reentry rounds derive the next compact
    # frontier from the O(cape) edge arrays (no bitmap round-trip).
    # Sweep chain capacities that force every regime — chaining disabled
    # (0), tiny caps that overflow mid-run and fall back to bitmap
    # rounds, and caps that hold the whole run chained — all bitwise
    # equal to the Dijkstra oracle.
    from mini_tpu.graph import grid2d

    hg = grid2d(24, 24, seed=5, weighted=True)
    gs = GraphSlice.from_host(hg)
    for src in (0, 300):
        exp, _ = sssp_cpu(hg, src)
        for ccap in (0, 8, 64, 4096, None):
            res = sssp(
                gs, src=src, variant="delta", chain_cap=ccap,
                with_preds=False,
            )
            np.testing.assert_array_equal(
                np.asarray(res.dists)[: hg.n], exp,
                err_msg=f"chain_cap={ccap} src={src}",
            )
            assert not bool(res.sparse_overflowed)


def test_bfs_chained_rounds_match_oracle():
    # round-5 compact chaining for BFS: sparse reentry rounds derive the
    # next frontier indices->indices (ops/sparse.visit_and_chain), with
    # the bitmap path reconstructing the frontier as labels == it.
    # Sweep caps covering disabled / overflow-fallback / fully-chained,
    # all bitwise vs the oracle.
    from mini_tpu.graph import grid2d

    hg = grid2d(24, 24, seed=6)
    gs = GraphSlice.from_host(hg)
    for src in (0, 300):
        exp = bfs_cpu(hg, src)
        for ccap in (0, 8, 64, 4096, None):
            res = bfs(gs, src=src, chain_cap=ccap)
            np.testing.assert_array_equal(
                np.asarray(res.labels)[: hg.n], exp,
                err_msg=f"chain_cap={ccap} src={src}",
            )
            assert not bool(res.sparse_overflowed)
            assert validate_preds(
                np.asarray(res.labels)[: hg.n],
                np.asarray(res.preds), hg, src,
            )
