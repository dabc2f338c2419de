"""Operator-core unit tests: segment reduces, frontier, advance/filter/
neighborhood, SpMM/SDDMM — all validated against NumPy dense oracles
(advance == masked SpMV on small graphs, per SURVEY.md §4)."""

import numpy as np
import pytest
import jax.numpy as jnp

from mini_tpu.ops import (
    Frontier,
    segment_reduce,
    segment_argmin_by,
    compact_mask,
    uniquify,
    advance,
    apply_to_dst,
    filter_frontier,
    neighborhood_reduce,
    compute,
    spmm,
    sddmm,
    reduce_by_dst,
    exclusive_cumsum,
)


def dense_adj(hg):
    a = np.zeros((hg.n, hg.n), dtype=np.float64)
    np.add.at(a, (hg.csr_srcs, hg.csr_dsts), hg.csr_weights)
    return a


# ---------------------------------------------------------------- segment ops
def test_segment_reduce_sum_min_max():
    vals = jnp.array([1.0, 2.0, 3.0, 4.0, 5.0])
    seg = jnp.array([0, 0, 1, 3, 3])
    s = segment_reduce(vals, seg, 5, "sum")
    np.testing.assert_array_equal(s, [3.0, 3.0, 0.0, 9.0, 0.0])
    mn = segment_reduce(vals, seg, 5, "min")
    assert mn[0] == 1.0 and mn[3] == 4.0 and np.isinf(mn[2])
    mx = segment_reduce(vals, seg, 5, "max")
    assert mx[0] == 2.0 and mx[3] == 5.0


def test_segment_reduce_masked_bool():
    vals = jnp.array([True, True, False, True])
    seg = jnp.array([0, 1, 1, 2])
    mask = jnp.array([True, False, True, True])
    # seg0: True; seg1: only the unmasked False contributes; seg2: True;
    # seg3: empty -> identity False
    r = segment_reduce(vals, seg, 4, "or", mask=mask)
    np.testing.assert_array_equal(np.asarray(r), [True, False, True, False])
    ra = segment_reduce(vals, seg, 4, "and", mask=mask)
    np.testing.assert_array_equal(np.asarray(ra), [True, False, True, True])


def test_segment_argmin_by():
    keys = jnp.array([5.0, 3.0, 3.0, 7.0])
    payload = jnp.array([9, 4, 2, 1])
    seg = jnp.array([0, 0, 0, 1])
    mk, mp = segment_argmin_by(keys, payload, seg, 2)
    assert mk[0] == 3.0 and mp[0] == 2  # smallest payload among key-minima
    assert mk[1] == 7.0 and mp[1] == 1


def test_exclusive_cumsum():
    x = jnp.array([1, 2, 3])
    np.testing.assert_array_equal(np.asarray(exclusive_cumsum(x)), [0, 1, 3])


# ------------------------------------------------------------------ frontier
def test_frontier_roundtrip():
    f = Frontier.from_indices(jnp.array([2, 5, 5, -1]), 8)
    assert int(f.size()) == 2
    idx, count, overflow = f.to_indices(4)
    assert int(count) == 2
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(idx), [2, 5, -1, -1])


def test_frontier_full_empty():
    f = Frontier.full(16, 5)
    assert int(f.size()) == 5
    assert int(Frontier.empty(16).size()) == 0


def test_compact_mask_capacity_clip_flags_overflow():
    mask = jnp.array([True] * 6 + [False] * 2)
    idx, count, overflow = compact_mask(mask, 4)
    assert int(count) == 4
    assert bool(overflow)  # 6 set bits > capacity 4 must be DETECTED
    np.testing.assert_array_equal(np.asarray(idx), [0, 1, 2, 3])
    # exactly-at-capacity is not an overflow
    _, count6, ov6 = compact_mask(mask, 6)
    assert int(count6) == 6 and not bool(ov6)


def test_uniquify_exact():
    idx = jnp.array([3, 1, 3, 3, 1, -1, 7])
    out, count, overflow = uniquify(idx, 16, capacity=8)
    assert int(count) == 3
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(out)[:3], [1, 3, 7])


# ----------------------------------------------------------------- operators
def test_advance_push_matches_dense(random_slice, random_graph):
    a = dense_adj(random_graph) > 0
    rng = np.random.RandomState(0)
    mask_np = rng.rand(random_slice.n_pad) < 0.2
    mask_np[random_graph.n:] = False
    f = Frontier(jnp.asarray(mask_np))
    nxt, ev, active = advance(random_slice, f, direction="push")
    expected = (mask_np[: random_graph.n] @ a) > 0
    got = np.asarray(nxt.mask)[: random_graph.n]
    np.testing.assert_array_equal(got, expected)
    assert not np.asarray(nxt.mask)[random_graph.n:].any()


def test_advance_cond(random_slice, random_graph):
    # only traverse edges with weight > 32
    f = Frontier.full(random_slice.n_pad, random_graph.n)
    nxt, ev, active = advance(
        random_slice, f, cond=lambda e: e.weight > 32, direction="push"
    )
    a = dense_adj(random_graph)
    heavy = np.zeros((random_graph.n, random_graph.n))
    np.add.at(
        heavy,
        (random_graph.csr_srcs, random_graph.csr_dsts),
        random_graph.csr_weights > 32,
    )
    expected = heavy.sum(axis=0) > 0
    np.testing.assert_array_equal(
        np.asarray(nxt.mask)[: random_graph.n], expected
    )


def test_apply_to_dst_min(random_slice, random_graph):
    f = Frontier.full(random_slice.n_pad, random_graph.n)
    nxt, ev, active = advance(random_slice, f, direction="push")
    dist = jnp.zeros(random_slice.n_pad)
    vals = dist[ev.src] + ev.weight
    out = apply_to_dst(random_slice, ev, active, vals, "min")
    # oracle: min incoming weight per vertex
    expected = np.full(random_graph.n, np.inf)
    np.minimum.at(
        expected, random_graph.csr_dsts, random_graph.csr_weights
    )
    np.testing.assert_allclose(
        np.asarray(out)[: random_graph.n], expected
    )


def test_filter_is_mask_and():
    f = Frontier(jnp.array([True, True, False, True]))
    out = filter_frontier(f, jnp.array([True, False, True, True]))
    np.testing.assert_array_equal(
        np.asarray(out.mask), [True, False, False, True]
    )


def test_neighborhood_reduce_pull_sum(random_slice, random_graph):
    """neighborhood(pull, sum of src ranks) == A^T @ ranks (SpMV oracle)."""
    rng = np.random.RandomState(1)
    ranks = rng.rand(random_slice.n_pad).astype(np.float32)
    r = jnp.asarray(ranks)
    f = Frontier.full(random_slice.n_pad, random_graph.n)
    out = neighborhood_reduce(
        random_slice, f, lambda e: r[e.src], op="sum", direction="pull"
    )
    a = (dense_adj(random_graph) > 0).astype(np.float64)
    # duplicate edges each contribute, so use multiplicity
    mult = np.zeros((random_graph.n, random_graph.n))
    np.add.at(mult, (random_graph.csr_srcs, random_graph.csr_dsts), 1.0)
    expected = mult.T @ ranks[: random_graph.n]
    np.testing.assert_allclose(
        np.asarray(out)[: random_graph.n], expected, rtol=1e-5
    )


def test_neighborhood_reduce_push_min(random_slice, random_graph):
    rng = np.random.RandomState(2)
    h = rng.randint(0, 1000, random_slice.n_pad)
    hv = jnp.asarray(h)
    f = Frontier.full(random_slice.n_pad, random_graph.n)
    out = neighborhood_reduce(
        random_slice, f, lambda e: hv[e.dst], op="min", direction="push"
    )
    expected = np.full(random_graph.n, np.iinfo(np.int64).max)
    np.minimum.at(expected, random_graph.csr_srcs, h[random_graph.csr_dsts])
    got = np.asarray(out)[: random_graph.n]
    nonempty = np.diff(random_graph.row_offsets) > 0
    np.testing.assert_array_equal(got[nonempty], expected[nonempty])


def test_compute_on_frontier():
    f = Frontier(jnp.array([True, False, True, False]))
    state = jnp.array([1.0, 2.0, 3.0, 4.0])
    out = compute(f, lambda s: s * 10, state)
    np.testing.assert_array_equal(np.asarray(out), [10.0, 2.0, 30.0, 4.0])


# ---------------------------------------------------------------- spmm/sddmm
def test_spmm_pull_matches_dense(random_slice, random_graph):
    rng = np.random.RandomState(3)
    x = rng.rand(random_slice.n_pad, 8).astype(np.float32)
    out = spmm(random_slice, jnp.asarray(x), direction="pull")
    a = dense_adj(random_graph)
    expected = a.T @ x[: random_graph.n]
    np.testing.assert_allclose(
        np.asarray(out)[: random_graph.n], expected, rtol=1e-4
    )


def test_spmm_push_matches_dense(random_slice, random_graph):
    rng = np.random.RandomState(4)
    x = rng.rand(random_slice.n_pad, 4).astype(np.float32)
    out = spmm(random_slice, jnp.asarray(x), direction="push")
    a = dense_adj(random_graph)
    expected = a @ x[: random_graph.n]
    np.testing.assert_allclose(
        np.asarray(out)[: random_graph.n], expected, rtol=1e-4
    )


def test_spmm_vector_input(random_slice, random_graph):
    rng = np.random.RandomState(5)
    x = rng.rand(random_slice.n_pad).astype(np.float32)
    out = spmm(random_slice, jnp.asarray(x), direction="pull")
    assert out.shape == (random_slice.n_pad,)
    expected = dense_adj(random_graph).T @ x[: random_graph.n]
    np.testing.assert_allclose(
        np.asarray(out)[: random_graph.n], expected, rtol=1e-4
    )


@pytest.mark.parametrize("direction", ["pull", "push"])
def test_spmm_multi_head_matches_dense(random_slice, random_graph, direction):
    # heads=3: head h's block of x is scaled by its own weight column
    heads, d = 3, 5
    rng = np.random.RandomState(8)
    n = random_graph.n
    x = rng.rand(random_slice.n_pad, heads * d).astype(np.float32)
    w = rng.rand(random_slice.m_pad, heads).astype(np.float32)
    out = np.asarray(spmm(
        random_slice, jnp.asarray(x), direction=direction,
        weights=jnp.asarray(w), heads=heads,
    ))[:n]
    if direction == "pull":  # weights in CSC order: out[dst] += w x[src]
        src, dst = random_graph.csc_srcs, random_graph.csc_dsts
        seg, nbr = dst, src
    else:  # weights in CSR order: out[src] += w x[dst]
        src, dst = random_graph.csr_srcs, random_graph.csr_dsts
        seg, nbr = src, dst
    for h in range(heads):
        a = np.zeros((n, n))
        np.add.at(a, (seg, nbr), w[: random_graph.m, h])
        np.testing.assert_allclose(
            out[:, h * d: (h + 1) * d], a @ x[:n, h * d: (h + 1) * d],
            rtol=1e-4, atol=1e-5,
        )


def test_sddmm_matches_dense(random_slice, random_graph):
    rng = np.random.RandomState(6)
    x = rng.rand(random_slice.n_pad, 8).astype(np.float32)
    vals = sddmm(random_slice, jnp.asarray(x), order="csr")
    expected = np.sum(
        x[random_graph.csr_srcs] * x[random_graph.csr_dsts], axis=-1
    )
    np.testing.assert_allclose(
        np.asarray(vals)[: random_graph.m], expected, rtol=1e-4
    )
    assert np.all(np.asarray(vals)[random_graph.m:] == 0)


def test_reduce_by_dst_sum(random_slice, random_graph):
    ones = jnp.ones(random_slice.m_pad)
    indeg = reduce_by_dst(random_slice, ones, op="sum")
    np.testing.assert_array_equal(
        np.asarray(indeg)[: random_graph.n].astype(int),
        random_graph.in_degrees,
    )
