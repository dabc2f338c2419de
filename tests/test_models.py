"""GAT / GraphSAGE forward tests vs dense NumPy oracles."""

import numpy as np
import jax
import jax.numpy as jnp

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.models.gat import gat_init, gat_forward, gat_forward_cpu
from mini_tpu.models.sage import sage_init, sage_forward, sage_forward_cpu


def _setup(seed=0, n=80, m=500, fin=8):
    hg = erdos_renyi(n, m, seed=seed, undirected=True)
    gs = GraphSlice.from_host(hg)
    rng = np.random.RandomState(seed)
    x = rng.rand(gs.n_pad, fin).astype(np.float32)
    x[hg.n:] = 0
    return hg, gs, jnp.asarray(x)


def test_gat_forward_matches_oracle():
    hg, gs, x = _setup()
    params = gat_init(jax.random.PRNGKey(0), [8, 16, 3], heads=2)
    out = gat_forward(params, gs, x)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    expect = gat_forward_cpu(params_np, hg, np.asarray(x))
    np.testing.assert_allclose(
        np.asarray(out)[: hg.n], expect, rtol=1e-3, atol=1e-4
    )


def test_gat_attention_rows_sum_to_one():
    from mini_tpu.models.gat import segment_softmax_by_dst
    from mini_tpu.ops.engine import reduce_csc_by_dst

    hg, gs, x = _setup(seed=1)
    rng = np.random.RandomState(1)
    scores = jnp.asarray(rng.randn(gs.m_pad).astype(np.float32))
    alpha = segment_softmax_by_dst(gs, scores)
    sums = np.asarray(reduce_csc_by_dst(gs, alpha, "sum"))
    has_in = hg.in_degrees > 0
    np.testing.assert_allclose(
        sums[: hg.n][has_in], 1.0, rtol=1e-5
    )
    assert np.all(np.asarray(alpha)[np.asarray(gs.edge_mask_csc) == 0] == 0)


def test_sage_forward_matches_oracle():
    hg, gs, x = _setup(seed=2)
    params = sage_init(jax.random.PRNGKey(2), [8, 16, 4])
    out = sage_forward(params, gs, x)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    expect = sage_forward_cpu(params_np, hg, np.asarray(x))
    np.testing.assert_allclose(
        np.asarray(out)[: hg.n], expect, rtol=1e-4, atol=1e-5
    )


def test_gat_trains():
    hg, gs, x = _setup(seed=3, n=60, m=400)
    params = gat_init(jax.random.PRNGKey(3), [8, 8, 2], heads=2)
    labels = jnp.asarray(
        np.random.RandomState(3).randint(0, 2, gs.n_pad)
    )
    mask = jnp.arange(gs.n_pad) < hg.n

    def loss_fn(p):
        logits = gat_forward(p, gs, x)
        logp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(logp, labels[:, None], -1)[:, 0]
        return jnp.sum(jnp.where(mask, nll, 0)) / hg.n

    g0 = jax.grad(loss_fn)(params)
    norms = [float(jnp.abs(l).sum()) for l in jax.tree_util.tree_leaves(g0)]
    assert all(np.isfinite(n) for n in norms)
    assert sum(norms) > 0


def test_gat_bf16_message_path_close_to_f32():
    """The bf16 message fast path (batched heads) stays within bf16
    tolerance of the f32 forward."""
    hg, gs, x = _setup(5)
    params = gat_init(jax.random.PRNGKey(5), [8, 16, 3], heads=2)
    out32 = gat_forward(params, gs, x)
    out16 = gat_forward(params, gs, x, message_dtype=jnp.bfloat16)
    np.testing.assert_allclose(
        np.asarray(out16), np.asarray(out32), rtol=3e-2, atol=3e-2
    )


def test_gat_three_heads_d250_matches_oracle_and_softmax():
    # the arxiv GAT width (3 heads x 250): the default fused attention
    # matches the NumPy oracle and the exact-softmax path
    hg, gs, x = _setup(seed=4)
    params = gat_init(jax.random.PRNGKey(6), [8, 250, 5], heads=3)
    out = gat_forward(params, gs, x)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    expect = gat_forward_cpu(params_np, hg, np.asarray(x))
    np.testing.assert_allclose(
        np.asarray(out)[: hg.n], expect, rtol=1e-3, atol=1e-4
    )
    soft = gat_forward(params, gs, x, attn="softmax")
    np.testing.assert_allclose(
        np.asarray(out)[: hg.n], np.asarray(soft)[: hg.n],
        rtol=1e-4, atol=1e-5,
    )


def test_sage_train_step_decreases_loss():
    from mini_tpu.models.sage import (
        sage_init, sage_init_opt, sage_train_step,
    )

    hg, gs, x = _setup(seed=9)
    params = sage_init(jax.random.PRNGKey(9), [8, 16, 4])
    opt = sage_init_opt(params)
    rng = np.random.RandomState(9)
    lab = jnp.asarray(rng.randint(0, 4, gs.n_pad))
    msk = jnp.arange(gs.n_pad) < hg.n
    losses = []
    for _ in range(5):
        params, opt, loss = sage_train_step(
            params, opt, gs, x, (lab, msk), 0.1
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_gat_train_step_decreases_loss():
    from mini_tpu.models.gat import (
        gat_init_opt, gat_train_step,
    )

    hg, gs, x = _setup(seed=10)
    params = gat_init(jax.random.PRNGKey(10), [8, 16, 4], heads=2)
    opt = gat_init_opt(params)
    rng = np.random.RandomState(10)
    lab = jnp.asarray(rng.randint(0, 4, gs.n_pad))
    msk = jnp.arange(gs.n_pad) < hg.n
    losses = []
    for _ in range(5):
        params, opt, loss = gat_train_step(
            params, opt, gs, x, (lab, msk), 0.1
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
