"""Distributed L-Spar + GAT/SAGE forwards vs their single-device forms
(the beyond-reference models ride the multi-device path too)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.parallel import (
    partition_graph,
    make_mesh,
    shard_to_mesh,
    build_halo_plan,
    dist_lspar,
    dist_gat_forward,
    dist_sage_forward,
)

NDEV = len(jax.devices())
pytestmark = pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")


def _setup(seed=11, n=240, m=2000, F=8):
    hg = erdos_renyi(n, m, seed=seed, undirected=True)
    mesh = make_mesh(NDEV)
    pg = partition_graph(hg, NDEV)
    shards = shard_to_mesh(pg, mesh)
    plan = build_halo_plan(pg)
    rng = np.random.RandomState(seed)
    xn = rng.rand(n, F).astype(np.float32) * 0.1
    x_dist = np.zeros((pg.num_shards, pg.n_loc, F), np.float32)
    x_dist.reshape(-1, F)[:n] = xn
    gs = GraphSlice.from_host(hg)
    x_single = np.zeros((gs.n_pad, F), np.float32)
    x_single[:n] = xn
    return hg, gs, pg, shards, plan, mesh, jnp.asarray(x_dist), jnp.asarray(
        x_single)


def test_dist_lspar_matches_single_chip():
    from mini_tpu.algorithms import lspar

    hg, gs, pg, shards, plan, mesh, _, _ = _setup()
    single = lspar(gs, prime=999983, e=0.5, seed=0)
    for pl in (None, plan):
        sel, sims, cnt = dist_lspar(
            pg, shards, mesh, prime=999983, e=0.5, seed=0, plan=pl
        )
        assert int(cnt) == int(single.num_selected)
        # per-vertex selected counts: the dist CSC segment of v is v's
        # adjacency, so its count must equal the single-chip per-src count
        sel_np = np.asarray(sel).reshape(-1)
        dsts = np.concatenate(
            [pg.csc_dsts_local[s] + s * pg.n_loc
             for s in range(pg.num_shards)]
        )
        per_v_dist = np.bincount(
            dsts[sel_np], minlength=pg.n_pad
        )[: hg.n]
        per_v_single = np.bincount(
            np.asarray(gs.csr_srcs)[np.asarray(single.selected_mask)],
            minlength=gs.n_pad,
        )[: hg.n]
        np.testing.assert_array_equal(per_v_dist, per_v_single)


def test_dist_sage_forward_matches_single_chip():
    from mini_tpu.models.sage import sage_init, sage_forward

    hg, gs, pg, shards, plan, mesh, x_d, x_s = _setup(F=8)
    params = sage_init(jax.random.PRNGKey(2), [8, 16, 4])
    expect = np.asarray(
        sage_forward(params, gs, x_s)
    )[: hg.n]
    for pl in (None, plan):
        got = np.asarray(
            dist_sage_forward(pg, shards, mesh, params, x_d, plan=pl)
        ).reshape(pg.n_pad, -1)[: hg.n]
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_dist_gat_forward_matches_single_chip():
    from mini_tpu.models.gat import gat_init, gat_forward

    hg, gs, pg, shards, plan, mesh, x_d, x_s = _setup(F=8)
    params = gat_init(jax.random.PRNGKey(3), [8, 16, 3], heads=2)
    expect = np.asarray(
        gat_forward(params, gs, x_s, attn="fused")
    )[: hg.n]
    for pl in (None, plan):
        got = np.asarray(
            dist_gat_forward(pg, shards, mesh, params, x_d, plan=pl)
        ).reshape(pg.n_pad, -1)[: hg.n]
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def _train_setup(F=8, n_classes=4, seed=13):
    hg, gs, pg, shards, plan, mesh, x_d, x_s = _setup(seed=seed, F=F)
    rng = np.random.RandomState(seed)
    lab = np.zeros((pg.num_shards, pg.n_loc), np.int32)
    lab.reshape(-1)[: hg.n] = rng.randint(0, n_classes, hg.n)
    msk = (np.arange(pg.n_pad) < hg.n).reshape(pg.num_shards, pg.n_loc)
    from jax.sharding import NamedSharding, PartitionSpec as P

    row = NamedSharding(mesh, P("graph"))
    return (
        hg, pg, shards, plan, mesh, x_d,
        jax.device_put(jnp.asarray(lab), row),
        jax.device_put(jnp.asarray(msk), row),
    )


def test_dist_sage_train_loss_decreases():
    from mini_tpu.models.sage import sage_init
    from mini_tpu.parallel.models import dist_sage_train

    hg, pg, shards, plan, mesh, x_d, lab, msk = _train_setup()
    params = sage_init(jax.random.PRNGKey(4), [8, 16, 4])
    _, losses = dist_sage_train(
        pg, shards, mesh, params, x_d, lab, msk, steps=5, lr=0.1
    )
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # boundary-only halo exchange computes the same function: the loss
    # trajectory must match the all-gather form to fp tolerance
    _, losses_bd = dist_sage_train(
        pg, shards, mesh, params, x_d, lab, msk, steps=5, lr=0.1,
        plan=plan,
    )
    np.testing.assert_allclose(losses_bd, losses, rtol=1e-5)


def test_dist_gat_train_loss_decreases():
    from mini_tpu.models.gat import gat_init
    from mini_tpu.parallel.models import dist_gat_train

    hg, pg, shards, plan, mesh, x_d, lab, msk = _train_setup()
    params = gat_init(jax.random.PRNGKey(5), [8, 16, 4], heads=2)
    _, losses = dist_gat_train(
        pg, shards, mesh, params, x_d, lab, msk, steps=5, lr=0.1
    )
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    _, losses_bd = dist_gat_train(
        pg, shards, mesh, params, x_d, lab, msk, steps=5, lr=0.1,
        plan=plan,
    )
    np.testing.assert_allclose(losses_bd, losses, rtol=1e-5)


def test_dist_gat_train_grads_match_single_chip():
    # one step's gradient vs jax.grad of the single-chip fused forward
    # with the same loss: the distributed backward (collectives under
    # value_and_grad) must compute the same cotangents
    from mini_tpu.models.gat import gat_init, gat_forward
    from mini_tpu.parallel.models import dist_gat_train

    hg, gs, pg, shards, plan, mesh, x_d, x_s = _setup(seed=13, F=8)
    rng = np.random.RandomState(13)
    lab_n = rng.randint(0, 4, hg.n)
    lab = np.zeros((pg.num_shards, pg.n_loc), np.int32)
    lab.reshape(-1)[: hg.n] = lab_n
    msk = (np.arange(pg.n_pad) < hg.n).reshape(pg.num_shards, pg.n_loc)
    from jax.sharding import NamedSharding, PartitionSpec as P

    row = NamedSharding(mesh, P("graph"))
    lab_d = jax.device_put(jnp.asarray(lab), row)
    msk_d = jax.device_put(jnp.asarray(msk), row)
    params = gat_init(jax.random.PRNGKey(5), [8, 16, 4], heads=2)

    lr = 0.5
    new_params, _ = dist_gat_train(
        pg, shards, mesh, params, x_d, lab_d, msk_d, steps=1, lr=lr
    )

    def loss_single(p):
        logits = gat_forward(p, gs, x_s, attn="fused")[: hg.n]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(lab_n)[:, None], axis=-1
        )[:, 0]
        return jnp.mean(nll)

    g_single = jax.grad(loss_single)(params)
    # first momentum step: new = p - lr * grad
    for layer_new, layer_old, layer_g in zip(new_params, params, g_single):
        for k in layer_new:
            got = (np.asarray(layer_old[k]) - np.asarray(layer_new[k])) / lr
            np.testing.assert_allclose(
                got, np.asarray(layer_g[k]), rtol=1e-3, atol=1e-5
            )
