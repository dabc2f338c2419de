"""Sorted-engine primitive tests: exact expansion, sort-permutation,
segmented scan reduces — validated against direct gather/scatter oracles."""

import numpy as np
import jax.numpy as jnp

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.ops.permute import (
    expand_to_edges,
    apply_fixed_perm,
    segmented_scan_reduce,
)
from mini_tpu.ops.engine import (
    src_vals_to_csc,
    dst_vals_to_csc,
    dst_vals_to_csr,
    reduce_csc_by_dst,
    reduce_csr_by_src,
)


def _slice(seed=0):
    hg = erdos_renyi(150, 900, seed=seed, undirected=True, weighted=True)
    return hg, GraphSlice.from_host(hg)


def test_expand_int_exact():
    hg, gs = _slice()
    rng = np.random.RandomState(0)
    v = rng.randint(-(2**31), 2**31 - 1, gs.n_pad).astype(np.int32)
    out = expand_to_edges(jnp.asarray(v), gs.row_offsets, gs.m_pad)
    expect = v[np.asarray(gs.csr_srcs)]
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_expand_float_bit_exact():
    hg, gs = _slice(1)
    rng = np.random.RandomState(1)
    v = rng.randn(gs.n_pad).astype(np.float32)
    v[::7] = np.inf
    v[3::11] = -0.0
    out = expand_to_edges(jnp.asarray(v), gs.col_offsets, gs.m_pad)
    expect = v[np.asarray(gs.csc_dsts)]
    # bitwise comparison via views
    np.testing.assert_array_equal(
        np.asarray(out).view(np.int32), expect.view(np.int32)
    )


def test_apply_fixed_perm_roundtrip():
    hg, gs = _slice(2)
    rng = np.random.RandomState(2)
    vals = rng.rand(gs.m_pad).astype(np.float32)
    # CSR -> CSC: out[rank[i]] = vals[i]
    out = apply_fixed_perm(gs.csr_to_csc_rank, jnp.asarray(vals))
    expect = np.empty_like(vals)
    expect[np.asarray(gs.csr_to_csc_rank)] = vals
    np.testing.assert_array_equal(np.asarray(out), expect)
    # two payloads share the sort
    a, b = apply_fixed_perm(
        gs.csr_to_csc_rank, jnp.asarray(vals), jnp.asarray(vals * 2)
    )
    np.testing.assert_array_equal(np.asarray(a) * 2, np.asarray(b))


def test_src_vals_to_csc_matches_gather():
    hg, gs = _slice(3)
    rng = np.random.RandomState(3)
    v = rng.randint(0, 1000, gs.n_pad).astype(np.int32)
    out = src_vals_to_csc(gs, jnp.asarray(v))
    np.testing.assert_array_equal(
        np.asarray(out), v[np.asarray(gs.csc_srcs)]
    )


def test_dst_vals_to_csr_matches_gather():
    hg, gs = _slice(4)
    rng = np.random.RandomState(4)
    v = rng.randint(0, 1000, gs.n_pad).astype(np.int32)
    out = dst_vals_to_csr(gs, jnp.asarray(v))
    np.testing.assert_array_equal(
        np.asarray(out), v[np.asarray(gs.csr_dsts)]
    )


def test_segmented_scan_min_max_sum():
    hg, gs = _slice(5)
    rng = np.random.RandomState(5)
    vals = rng.randint(0, 10000, gs.m_pad).astype(np.int32)
    dsts = np.asarray(gs.csc_dsts)
    for op, npop, ident in (
        ("min", np.minimum, np.iinfo(np.int32).max),
        ("max", np.maximum, np.iinfo(np.int32).min),
    ):
        out = segmented_scan_reduce(
            jnp.asarray(vals), gs.csc_dsts, gs.col_offsets, op,
            jnp.int32(ident),
        )
        expect = np.full(gs.n_pad, ident, np.int64)
        npop.at(expect, dsts, vals)
        np.testing.assert_array_equal(np.asarray(out), expect)
    # float sum via scan vs float64 oracle
    fvals = rng.rand(gs.m_pad).astype(np.float32)
    out = segmented_scan_reduce(
        jnp.asarray(fvals), gs.csc_dsts, gs.col_offsets, "sum",
        jnp.float32(0),
    )
    expect = np.zeros(gs.n_pad)
    np.add.at(expect, dsts, fvals.astype(np.float64))
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5)


def test_reduce_helpers_match_scatter(random_slice, random_graph):
    gs = random_slice
    rng = np.random.RandomState(6)
    ev = rng.randint(0, 100, gs.m_pad).astype(np.int32)
    out = reduce_csc_by_dst(gs, jnp.asarray(ev), "sum")
    expect = np.zeros(gs.n_pad, np.int64)
    np.add.at(expect, np.asarray(gs.csc_dsts), ev)
    np.testing.assert_array_equal(np.asarray(out), expect)
    out2 = reduce_csr_by_src(gs, jnp.asarray(ev), "max")
    expect2 = np.full(gs.n_pad, np.iinfo(np.int32).min, np.int64)
    np.maximum.at(expect2, np.asarray(gs.csr_srcs), ev)
    np.testing.assert_array_equal(np.asarray(out2), expect2)


def test_expand_batched_matches_per_column():
    """A trailing head axis must expand bit-identically to K separate calls."""
    hg, gs = _slice(7)
    rng = np.random.RandomState(7)
    v = rng.randn(gs.n_pad, 3).astype(np.float32)
    out = expand_to_edges(jnp.asarray(v), gs.col_offsets, gs.m_pad)
    for k in range(3):
        ref = expand_to_edges(jnp.asarray(v[:, k]), gs.col_offsets, gs.m_pad)
        np.testing.assert_array_equal(
            np.asarray(out[:, k]).view(np.int32),
            np.asarray(ref).view(np.int32),
        )


def test_segmented_scan_batched_matches_per_column():
    hg, gs = _slice(8)
    rng = np.random.RandomState(8)
    vals = rng.rand(gs.m_pad, 4).astype(np.float32)
    for op, ident in (("max", -np.inf), ("sum", 0.0)):
        out = segmented_scan_reduce(
            jnp.asarray(vals), gs.csc_dsts, gs.col_offsets, op,
            jnp.float32(ident),
        )
        for k in range(4):
            ref = segmented_scan_reduce(
                jnp.asarray(vals[:, k]), gs.csc_dsts, gs.col_offsets, op,
                jnp.float32(ident),
            )
            np.testing.assert_array_equal(
                np.asarray(out[:, k]), np.asarray(ref)
            )


def test_segment_softmax_batched_matches_per_head():
    from mini_tpu.models.gat import segment_softmax_by_dst

    hg, gs = _slice(9)
    rng = np.random.RandomState(9)
    scores = rng.randn(gs.m_pad, 2).astype(np.float32)
    out = segment_softmax_by_dst(gs, jnp.asarray(scores))
    for k in range(2):
        ref = segment_softmax_by_dst(gs, jnp.asarray(scores[:, k]))
        np.testing.assert_array_equal(np.asarray(out[:, k]), np.asarray(ref))


def test_engine_linear_op_vjps_match_indexed_autodiff(random_slice):
    # the engine's linear movers carry analytic custom VJPs (sort-based
    # transposes) so training never differentiates through lax.sort;
    # gradients must equal autodiff of the same math written
    # with plain gathers + segment_sum (independent machinery)
    import jax
    import jax.numpy as jnp

    g = random_slice
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.rand(g.n_pad).astype(np.float32))
    y = jnp.asarray(rng.rand(g.n_pad).astype(np.float32))
    z = jnp.asarray(rng.rand(g.n_pad).astype(np.float32))

    def f_engine(x, y, z):
        ex, ez = src_vals_to_csc(g, x, z)  # multi-payload form
        e = ex * dst_vals_to_csc(g, y) + 0.5 * ez
        e = jnp.where(g.edge_mask_csc, e, 0.0)
        return jnp.sum(reduce_csc_by_dst(g, e, "sum") ** 2)

    def f_indexed(x, y, z):
        e = x[g.csc_srcs] * y[g.csc_dsts] + 0.5 * z[g.csc_srcs]
        e = jnp.where(g.edge_mask_csc, e, 0.0)
        seg = jax.ops.segment_sum(e, g.csc_dsts, num_segments=g.n_pad)
        return jnp.sum(seg**2)

    np.testing.assert_allclose(
        float(f_engine(x, y, z)), float(f_indexed(x, y, z)), rtol=1e-5
    )
    ge = jax.grad(f_engine, argnums=(0, 1, 2))(x, y, z)
    gi = jax.grad(f_indexed, argnums=(0, 1, 2))(x, y, z)
    for a, b in zip(ge, gi):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        )
