"""GraphSAGE (mean aggregator) on the mini-tpu SpMM path.

out = act( [h ; mean_{u in N_in(v)} h_u] @ W + b )
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.spmm import spmm


def sage_init(
    key: jax.Array, dims: Sequence[int], dtype=jnp.float32
) -> list[dict]:
    params = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        fan_in = 2 * dims[i]
        scale = jnp.sqrt(6.0 / (fan_in + dims[i + 1]))
        params.append(
            {
                "w": jax.random.uniform(
                    sub, (fan_in, dims[i + 1]), dtype, -scale, scale
                ),
                "b": jnp.zeros((dims[i + 1],), dtype),
            }
        )
    return params


def sage_forward(
    params: list[dict], g: GraphSlice, x: jnp.ndarray
) -> jnp.ndarray:
    unit_w = jnp.where(g.edge_mask_csc, 1.0, 0.0).astype(jnp.float32)
    inv_deg = jnp.where(
        g.in_degrees > 0, 1.0 / g.in_degrees.astype(jnp.float32), 0.0
    )
    h = x
    for i, layer in enumerate(params):
        agg = spmm(g, h, direction="pull", weights=unit_w)
        agg = agg * inv_deg[:, None]
        h = jnp.dot(
            jnp.concatenate([h, agg], axis=-1),
            layer["w"],
            preferred_element_type=jnp.float32,
        ) + layer["b"]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def sage_forward_cpu(
    params_np: list[dict], hg: HostGraph, x: np.ndarray
) -> np.ndarray:
    n = hg.n
    mult = np.zeros((n, n))
    np.add.at(mult, (hg.csr_srcs, hg.csr_dsts), 1.0)
    inv_deg = np.where(
        hg.in_degrees > 0, 1.0 / np.maximum(hg.in_degrees, 1), 0.0
    )
    h = x[:n].astype(np.float64)
    for i, layer in enumerate(params_np):
        agg = (mult.T @ h) * inv_deg[:, None]
        h = np.concatenate([h, agg], axis=-1) @ layer["w"] + layer["b"]
        if i < len(params_np) - 1:
            h = np.maximum(h, 0)
    return h


# ------------------------------------------------------------- training
def sage_loss(
    params, g: GraphSlice, x, labels, label_mask
) -> jnp.ndarray:
    """Masked softmax cross-entropy over labeled vertices (the
    `models/gcn.gcn_loss` contract on the SAGE forward)."""
    logits = sage_forward(params, g, x)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    nll = jnp.where(label_mask, nll, 0.0)
    return jnp.sum(nll) / jnp.maximum(jnp.sum(label_mask), 1)


import functools as _functools


@_functools.partial(
    jax.jit, static_argnums=(5,), donate_argnums=(0, 1)
)
def sage_train_step(
    params, opt_state, g: GraphSlice, x, batch, lr: float = 1e-2,
):
    """One SGD-with-momentum step (same optimizer contract as
    `models/gcn.gcn_train_step`); ``batch = (labels, label_mask)``."""
    labels, label_mask = batch
    loss, grads = jax.value_and_grad(sage_loss)(
        params, g, x, labels, label_mask
    )
    new_opt = jax.tree_util.tree_map(
        lambda m, dw: 0.9 * m + dw, opt_state, grads
    )
    new_params = jax.tree_util.tree_map(
        lambda p, m: p - lr * m, params, new_opt
    )
    return new_params, new_opt, loss


def sage_init_opt(params):
    return jax.tree_util.tree_map(jnp.zeros_like, params)
