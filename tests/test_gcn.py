"""GCN model tests: forward allclose vs dense NumPy oracle, training step
convergence (per-layer activations allclose with matching downstream
accuracy)."""

import numpy as np
import jax
import jax.numpy as jnp

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.models.gcn import (
    gcn_normalize,
    gcn_init,
    gcn_forward,
    gcn_forward_cpu,
    gcn_loss,
    gcn_train_step,
    gcn_init_opt,
)


def _setup(n=120, m=700, fin=16, fhid=32, fout=4, seed=0):
    hg = erdos_renyi(n, m, seed=seed, undirected=True)
    gs = GraphSlice.from_host(hg)
    norm = gcn_normalize(gs)
    key = jax.random.PRNGKey(seed)
    params = gcn_init(key, [fin, fhid, fout])
    rng = np.random.RandomState(seed)
    x = rng.rand(gs.n_pad, fin).astype(np.float32)
    x[hg.n:] = 0.0
    return hg, gs, norm, params, jnp.asarray(x)


def test_gcn_forward_matches_dense_oracle():
    hg, gs, norm, params, x = _setup()
    logits = gcn_forward(params, gs, norm, x)
    params_np = [
        {"w": np.asarray(p["w"]), "b": np.asarray(p["b"])} for p in params
    ]
    expected = gcn_forward_cpu(params_np, hg, np.asarray(x))
    np.testing.assert_allclose(
        np.asarray(logits)[: hg.n], expected, rtol=1e-4, atol=1e-5
    )


def test_gcn_training_reduces_loss():
    """Fit teacher labels produced by a random GCN of the same shape —
    guaranteed-learnable signal."""
    hg, gs, norm, params, x = _setup()
    teacher = gcn_init(jax.random.PRNGKey(99), [16, 32, 4])
    labels = jnp.argmax(gcn_forward(teacher, gs, norm, x), axis=-1)
    mask = jnp.arange(gs.n_pad) < hg.n
    opt = gcn_init_opt(params)
    losses = []
    for _ in range(40):
        params, opt, loss = gcn_train_step(
            params, opt, gs, norm, x, (labels, mask), 0.2
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_gcn_overfits_community_labels():
    """Downstream sanity: two planted communities are linearly separable
    after aggregation."""
    rng = np.random.RandomState(2)
    n = 100
    # two dense blocks with sparse cross edges
    srcs, dsts = [], []
    for _ in range(1500):
        c = rng.randint(2)
        u = rng.randint(50) + 50 * c
        if rng.rand() < 0.9:
            v = rng.randint(50) + 50 * c
        else:
            v = rng.randint(50) + 50 * (1 - c)
        if u != v:
            srcs.append(u)
            dsts.append(v)
    from mini_tpu.graph import from_edges

    hg = from_edges(
        np.array(srcs), np.array(dsts), num_nodes=n, make_undirected=True
    )
    gs = GraphSlice.from_host(hg)
    norm = gcn_normalize(gs)
    x = rng.rand(gs.n_pad, 8).astype(np.float32)
    labels = jnp.asarray(
        np.concatenate(
            [np.zeros(50, np.int32), np.ones(50, np.int32),
             np.zeros(gs.n_pad - n, np.int32)]
        )
    )
    mask = jnp.arange(gs.n_pad) < n
    params = gcn_init(jax.random.PRNGKey(0), [8, 16, 2])
    opt = gcn_init_opt(params)
    for _ in range(60):
        params, opt, loss = gcn_train_step(
            params, opt, gs, norm, jnp.asarray(x), (labels, mask), 0.1
        )
    logits = gcn_forward(params, gs, norm, jnp.asarray(x))
    acc = float(
        jnp.mean(
            (jnp.argmax(logits[:n], -1) == labels[:n]).astype(jnp.float32)
        )
    )
    assert acc > 0.9, acc
