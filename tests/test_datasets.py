"""Dataset module tests + end-to-end GCN accuracy on the synthetic
arxiv-like dataset (downstream-accuracy sanity)."""

import numpy as np
import jax
import jax.numpy as jnp

from mini_tpu.graph import GraphSlice
from mini_tpu.graph.datasets import (
    synthetic_arxiv_like,
    load_npz_dataset,
)
from mini_tpu.models.gcn import (
    gcn_normalize,
    gcn_init,
    gcn_init_opt,
    gcn_forward,
    gcn_train_step,
)


def test_npz_roundtrip(tmp_path):
    ds = synthetic_arxiv_like(scale=7, feature_dim=8, num_classes=4)
    path = str(tmp_path / "ds.npz")
    np.savez(
        path,
        edges=np.stack([ds.graph.csr_srcs, ds.graph.csr_dsts], 1),
        features=ds.features,
        labels=ds.labels,
        train_mask=ds.train_mask,
    )
    ds2 = load_npz_dataset(path, undirected=False)
    assert ds2.graph.n == ds.graph.n
    assert ds2.num_classes == ds.num_classes
    np.testing.assert_array_equal(ds2.labels, ds.labels)


def test_synthetic_dataset_is_learnable():
    ds = synthetic_arxiv_like(scale=9, feature_dim=16, num_classes=5)
    gs = GraphSlice.from_host(ds.graph)
    norm = gcn_normalize(gs)
    x = np.zeros((gs.n_pad, 16), np.float32)
    x[: ds.graph.n] = ds.features
    labels = np.zeros(gs.n_pad, np.int32)
    labels[: ds.graph.n] = ds.labels
    train = np.zeros(gs.n_pad, bool)
    train[: ds.graph.n] = ds.train_mask
    test = np.zeros(gs.n_pad, bool)
    test[: ds.graph.n] = ds.test_mask

    params = gcn_init(jax.random.PRNGKey(0), [16, 32, ds.num_classes])
    opt = jax.tree_util.tree_map(jnp.zeros_like, params)
    xj, lj, tj = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(train)
    for _ in range(40):
        params, opt, loss = gcn_train_step(
            params, opt, gs, norm, xj, (lj, tj), 0.1
        )
    logits = gcn_forward(params, gs, norm, xj)
    pred = np.asarray(jnp.argmax(logits, -1))
    acc = (pred[test] == labels[test]).mean()
    assert acc > 0.7, acc
