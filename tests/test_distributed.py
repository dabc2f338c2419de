"""Multi-chip tests on the 8-device virtual CPU mesh (conftest forces
--xla_force_host_platform_device_count=8): edge partitioning, shard_map BFS,
distributed SpMM — validated against the single-chip path and NumPy oracles.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.algorithms import bfs_cpu
from mini_tpu.parallel import (
    partition_graph,
    make_mesh,
    shard_to_mesh,
    dist_bfs,
    dist_spmm,
)

NDEV = len(jax.devices())

pytestmark = pytest.mark.skipif(
    NDEV < 2, reason="needs multiple (virtual) devices"
)


@pytest.fixture(scope="module")
def setup():
    hg = erdos_renyi(500, 4000, seed=11, undirected=True, weighted=True)
    mesh = make_mesh(NDEV)
    pg = partition_graph(hg, NDEV)
    shards = shard_to_mesh(pg, mesh)
    return hg, mesh, pg, shards


def test_partition_covers_all_edges(setup):
    hg, mesh, pg, shards = setup
    assert pg.edge_mask.sum() == hg.m
    assert pg.n_pad == pg.num_shards * pg.n_loc
    # every edge lands in the shard owning its dst
    for s in range(pg.num_shards):
        em = pg.edge_mask[s]
        dst_global = pg.csc_dsts_local[s][em] + s * pg.n_loc
        assert np.all(dst_global >= s * pg.n_loc)
        assert np.all(dst_global < (s + 1) * pg.n_loc)
    # local offsets consistent
    for s in range(pg.num_shards):
        np.testing.assert_array_equal(
            np.diff(pg.col_offsets[s]),
            np.bincount(
                pg.csc_dsts_local[s][pg.edge_mask[s]], minlength=pg.n_loc
            ),
        )


def test_dist_bfs_matches_oracle(setup):
    hg, mesh, pg, shards = setup
    labels, preds = dist_bfs(pg, shards, src=0, mesh=mesh)
    expected = bfs_cpu(hg, 0)
    np.testing.assert_array_equal(np.asarray(labels)[: hg.n], expected)


def test_dist_bfs_matches_single_chip(setup):
    hg, mesh, pg, shards = setup
    from mini_tpu.algorithms import bfs

    gs = GraphSlice.from_host(hg)
    single = bfs(gs, src=7)
    dist_labels, _ = dist_bfs(pg, shards, src=7, mesh=mesh)
    np.testing.assert_array_equal(
        np.asarray(dist_labels)[: hg.n],
        np.asarray(single.labels)[: hg.n],
    )


def test_dist_spmm_matches_dense(setup):
    hg, mesh, pg, shards = setup
    F = 8
    rng = np.random.RandomState(0)
    x_global = rng.rand(pg.n_pad, F).astype(np.float32)
    x_global[hg.n:] = 0.0
    x = x_global.reshape(pg.num_shards, pg.n_loc, F)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("graph")))
    out = dist_spmm(pg, shards, xs, mesh)
    got = np.asarray(out).reshape(pg.n_pad, F)[: hg.n]
    a = np.zeros((hg.n, hg.n))
    np.add.at(a, (hg.csr_srcs, hg.csr_dsts), hg.csr_weights)
    expected = a.T @ x_global[: hg.n]
    np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_graft_entry_and_dryrun():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] > 0
    ge.dryrun_multichip(NDEV)


def test_dist_sssp_matches_oracle(setup):
    from mini_tpu.parallel import dist_sssp
    from mini_tpu.algorithms import sssp_cpu

    hg, mesh, pg, shards = setup
    dists = dist_sssp(pg, shards, src=0, mesh=mesh)
    exp, _ = sssp_cpu(hg, 0)
    np.testing.assert_array_equal(np.asarray(dists)[: hg.n], exp)


def test_dist_pagerank_matches_single_chip(setup):
    from mini_tpu.graph import GraphSlice
    from mini_tpu.parallel.distributed import dist_pagerank
    from mini_tpu.algorithms import pagerank

    hg, mesh, pg, shards = setup
    gs = GraphSlice.from_host(hg)
    ref = np.asarray(pagerank(gs, variant="standard").ranks)[: hg.n]
    got, it = dist_pagerank(pg, shards, mesh)
    assert int(it) > 1
    np.testing.assert_allclose(
        np.asarray(got)[: hg.n], ref, rtol=1e-4, atol=1e-7
    )


def test_dist_cc_matches_oracle(setup):
    from mini_tpu.parallel.distributed import dist_cc
    from mini_tpu.algorithms import cc_cpu

    hg, mesh, pg, shards = setup
    got, it = dist_cc(pg, shards, mesh)
    np.testing.assert_array_equal(np.asarray(got)[: hg.n], cc_cpu(hg))


# ------------------------- boundary-only (HaloPlan) frontier exchange


@pytest.fixture(scope="module")
def halo_plan(setup):
    from mini_tpu.parallel.halo import build_halo_plan

    hg, mesh, pg, shards = setup
    return build_halo_plan(pg)


def test_dist_bfs_boundary_exchange_bitwise(setup, halo_plan):
    """Boundary-only frontier slabs must match the all-gather path (and
    the CPU oracle) BITWISE — same segmented reductions, less wire."""
    hg, mesh, pg, shards = setup
    l_ag, p_ag = dist_bfs(pg, shards, src=0, mesh=mesh)
    l_bd, p_bd = dist_bfs(pg, shards, src=0, mesh=mesh, plan=halo_plan)
    np.testing.assert_array_equal(np.asarray(l_ag), np.asarray(l_bd))
    np.testing.assert_array_equal(np.asarray(p_ag), np.asarray(p_bd))
    np.testing.assert_array_equal(
        np.asarray(l_bd)[: hg.n], bfs_cpu(hg, 0)
    )


def test_dist_sssp_boundary_exchange_bitwise(setup, halo_plan):
    from mini_tpu.parallel import dist_sssp
    from mini_tpu.algorithms import sssp_cpu

    hg, mesh, pg, shards = setup
    d_ag = dist_sssp(pg, shards, src=0, mesh=mesh)
    d_bd = dist_sssp(pg, shards, src=0, mesh=mesh, plan=halo_plan)
    np.testing.assert_array_equal(np.asarray(d_ag), np.asarray(d_bd))
    exp, _ = sssp_cpu(hg, 0)
    np.testing.assert_array_equal(np.asarray(d_bd)[: hg.n], exp)


def test_dist_pagerank_boundary_exchange(setup, halo_plan):
    from mini_tpu.parallel.distributed import dist_pagerank

    hg, mesh, pg, shards = setup
    r_ag, it_ag = dist_pagerank(pg, shards, mesh)
    r_bd, it_bd = dist_pagerank(pg, shards, mesh, plan=halo_plan)
    assert int(it_ag) == int(it_bd)
    np.testing.assert_array_equal(np.asarray(r_ag), np.asarray(r_bd))


def test_dist_cc_boundary_exchange(setup, halo_plan):
    from mini_tpu.parallel.distributed import dist_cc

    hg, mesh, pg, shards = setup
    got, _ = dist_cc(pg, shards, mesh, plan=halo_plan)
    ref, _ = dist_cc(pg, shards, mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_dist_coloring_matches_single_chip(setup, halo_plan):
    from mini_tpu.parallel.distributed import dist_coloring
    from mini_tpu.algorithms import coloring
    from mini_tpu.algorithms.coloring import validate_coloring

    hg, mesh, pg, shards = setup
    gs = GraphSlice.from_host(hg)
    ref = np.asarray(coloring(gs, seed=3).colors)
    got, it = dist_coloring(pg, shards, mesh, seed=3)
    got = np.asarray(got)
    assert validate_coloring(got, hg)
    # bitwise vs the single-chip fast path: same salts, same static-id
    # priorities, same claim order
    np.testing.assert_array_equal(got[: hg.n], ref[: hg.n])
    # boundary-exchange variant identical
    got_bd, _ = dist_coloring(pg, shards, mesh, seed=3, plan=halo_plan)
    np.testing.assert_array_equal(np.asarray(got_bd), np.asarray(got))


def test_dist_kcore_matches_single_chip(setup, halo_plan):
    from mini_tpu.parallel.distributed import dist_kcore
    from mini_tpu.algorithms import kcore
    from mini_tpu.algorithms.kcore import kcore_cpu_true

    hg, mesh, pg, shards = setup
    gs = GraphSlice.from_host(hg)
    ref = kcore(gs, variant="hindex")
    got, it = dist_kcore(pg, shards, mesh)
    np.testing.assert_array_equal(
        np.asarray(got)[: hg.n], np.asarray(ref.num_cores)[: hg.n]
    )
    cores_true, _ = kcore_cpu_true(hg)
    np.testing.assert_array_equal(np.asarray(got)[: hg.n], cores_true)
    got_bd, _ = dist_kcore(pg, shards, mesh, plan=halo_plan)
    np.testing.assert_array_equal(np.asarray(got_bd), np.asarray(got))
