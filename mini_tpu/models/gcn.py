"""Graph Convolutional Network on the mini-tpu graph slice.

The reference has no GNN — this generalizes its neighborhood-reduce into
an SpMM that also powers GNN message passing over the same CSR/CSC gslice.
Each layer computes

    H' = act( Â @ H @ W + b ),   Â = D̂^{-1/2} (A + I) D̂^{-1/2}

where the sparse product Â @ (H W) is the same SpMM operator the graph
algorithms use (`mini_tpu.ops.spmm`): the off-diagonal part is a pull-SpMM
with normalized edge weights, the self-loop diagonal is an elementwise
rescale.  The dense H @ W runs first (cheaper when output width < input
width).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mini_tpu.graph.csr import GraphSlice, HostGraph
from mini_tpu.ops.spmm import spmm


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GCNNorm:
    """Symmetric-normalized adjacency, split into sparse + diagonal parts."""

    edge_weights_csc: jnp.ndarray  # float32[m_pad]
    self_coeff: jnp.ndarray  # float32[n_pad]: 1/deg_hat diagonal


def gcn_normalize(g: GraphSlice) -> GCNNorm:
    """Â = D̂^-1/2 (A + I) D̂^-1/2 with deg_hat = in_deg + 1.

    For undirected graphs in/out degrees coincide; for directed graphs this
    is the standard pull-aggregation normalization.
    """
    real = jnp.arange(g.n_pad) < g.n
    deg_hat = jnp.where(real, g.in_degrees + 1, 1).astype(jnp.float32)
    inv_sqrt = jax.lax.rsqrt(deg_hat)
    w = inv_sqrt[g.csc_srcs] * inv_sqrt[g.csc_dsts]
    w = jnp.where(g.edge_mask_csc, w, 0.0)
    self_coeff = jnp.where(real, 1.0 / deg_hat, 0.0)
    return GCNNorm(edge_weights_csc=w, self_coeff=self_coeff)


def gcn_init(
    key: jax.Array, dims: Sequence[int], dtype=jnp.float32
) -> list[dict]:
    """Glorot-initialized layer parameters for dims[0] -> ... -> dims[-1]."""
    params = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        fan_in, fan_out = dims[i], dims[i + 1]
        scale = jnp.sqrt(6.0 / (fan_in + fan_out))
        params.append(
            {
                "w": jax.random.uniform(
                    sub, (fan_in, fan_out), dtype, -scale, scale
                ),
                "b": jnp.zeros((fan_out,), dtype),
            }
        )
    return params


def gcn_forward(
    params: list[dict],
    g: GraphSlice,
    norm: GCNNorm,
    x: jnp.ndarray,
    message_dtype=None,
) -> jnp.ndarray:
    """Forward pass; returns logits [n_pad, dims[-1]].

    ``message_dtype=jnp.bfloat16`` enables the fast aggregation path
    (half-width gather and messages; ~1e-3 relative error — fine for
    training, not for oracle comparisons).
    """
    h = x
    for i, layer in enumerate(params):
        hw = jnp.dot(h, layer["w"], preferred_element_type=jnp.float32)
        hw_msg = hw if message_dtype is None else hw.astype(message_dtype)
        agg = spmm(
            g,
            hw_msg,
            direction="pull",
            weights=norm.edge_weights_csc,
        ).astype(jnp.float32)
        h = agg + norm.self_coeff[:, None] * hw + layer["b"]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def gcn_loss(
    params, g, norm, x, labels, label_mask, message_dtype=None,
) -> jnp.ndarray:
    """Masked softmax cross-entropy over labeled vertices."""
    logits = gcn_forward(params, g, norm, x, message_dtype=message_dtype)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    nll = jnp.where(label_mask, nll, 0.0)
    return jnp.sum(nll) / jnp.maximum(jnp.sum(label_mask), 1)


@functools.partial(
    jax.jit, static_argnums=(6, 7), donate_argnums=(0, 1)
)
def gcn_train_step(
    params, opt_state, g, norm, x, batch, lr: float = 1e-2,
    message_dtype=None,
):
    """One SGD-with-momentum step (plain pytree optimizer; optax-compatible
    interfaces live one level up).  ``batch = (labels, label_mask)``.
    ``message_dtype`` selects the aggregation path exactly as in
    :func:`gcn_forward` (bf16 messages = the training fast path)."""
    labels, label_mask = batch
    loss, grads = jax.value_and_grad(gcn_loss)(
        params, g, norm, x, labels, label_mask, message_dtype
    )
    new_opt = jax.tree_util.tree_map(
        lambda m, dw: 0.9 * m + dw, opt_state, grads
    )
    new_params = jax.tree_util.tree_map(
        lambda p, m: p - lr * m, params, new_opt
    )
    return new_params, new_opt, loss


def gcn_init_opt(params):
    return jax.tree_util.tree_map(jnp.zeros_like, params)


# ----------------------------------------------------------------- oracles
def gcn_forward_cpu(
    params_np: list[dict], hg: HostGraph, x: np.ndarray
) -> np.ndarray:
    """NumPy/scipy sparse oracle of the forward pass (allclose
    validation).  Sparse so --validate works at rmat16+
    (the earlier dense n x n adjacency needed 34 GB at n=65k); bitwise the
    same math: out[v] = sum_{(u,v)} d[u] d[v] h[u] + d[v]^2 h[v] with
    d = deg_hat^-1/2, deg_hat = in_deg + 1 (multi-edges keep multiplicity).
    """
    import scipy.sparse as sp

    n = hg.n
    deg_hat = (hg.in_degrees.astype(np.float64) + 1.0)
    d = 1.0 / np.sqrt(deg_hat)
    src, dst = hg.csr_srcs, hg.csr_dsts
    # pull aggregation operator: row = dst, col = src (A_hat^T off-diagonal)
    agg = sp.csr_matrix(
        (d[src] * d[dst], (dst, src)), shape=(n, n), dtype=np.float64
    )
    self_coeff = (d * d)[:, None]
    h = x[:n].astype(np.float64)
    for i, layer in enumerate(params_np):
        hw = h @ layer["w"]
        h = agg @ hw + self_coeff * hw + layer["b"]
        if i < len(params_np) - 1:
            h = np.maximum(h, 0)
    return h
