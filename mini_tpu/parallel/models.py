"""Distributed GNN forwards beyond GCN: GAT and GraphSAGE on the
sharded mesh.

Both ride the same shard_map structure as `parallel/gcn.py`: per-dst
state and edges are shard-local (`partition.py`), parameters are
replicated, and the ONLY cross-shard traffic per layer is the feature
slab (and for GAT the [n]-vector of src scores) — boundary-only slabs
when a `HaloPlan` is given, full all-gather otherwise.

The GAT layer uses the fused-attention math of the single-chip path
(`models/gat.py`, attn="fused"): LeakyReLU's monotonicity makes
`LRelu(gmax + s_dst)` an exact-form stabilizer bound (gmax is one
`lax.pmax`), the unnormalized weights aggregate through the weighted
segment sum, and the denominator divides per vertex — no per-segment
softmax machinery, and outputs match the single-chip forward to fp
tolerance (tests/test_dist_models.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mini_tpu.parallel.partition import PartitionedGraph
from mini_tpu.parallel.distributed import (
    _make_edge_reader,
    _plan_args,
)
from mini_tpu.ops.segment import segment_reduce


def _make_mat_reader(use_plan, axis, esrc, send_idx, src_slot):
    """Like `_make_edge_reader` but for [n_loc, F] matrices: returns
    read(x_loc) -> [m_loc, F] source rows per edge."""
    from mini_tpu.parallel.halo import exchange_slabs

    if not use_plan:
        def read(x_loc):
            full = jax.lax.all_gather(x_loc, axis, tiled=True)
            return full[esrc]
        return read

    D, H = send_idx.shape[1], send_idx.shape[2]

    def read(x_loc):
        rows = x_loc[send_idx[0].reshape(-1)].reshape(D, H, -1)
        halo = exchange_slabs(rows, axis)  # [D, H, F] sender-major
        buf = jnp.concatenate([halo.reshape(D * H, -1), x_loc], axis=0)
        return buf[src_slot[0]]

    return read


def _sage_local(
    n_loc, use_plan, axis, g, x_loc, invd, send_idx, src_slot, params
):
    """Per-shard SAGE forward body (shared by the forward and the train
    step); ``x_loc``/``invd``/``send_idx``/``src_slot`` carry the [1, ...]
    leading shard axis shard_map leaves have."""
    esrc = g.csc_srcs[0]
    edst = g.csc_dsts_local[0]
    emask = g.edge_mask[0]
    read = _make_mat_reader(use_plan, axis, esrc, send_idx, src_slot)
    h = x_loc[0]
    for i, layer in enumerate(params):
        agg = segment_reduce(
            read(h), edst, n_loc, "sum", mask=emask[:, None]
        )
        agg = agg * invd[0][:, None]
        h = jnp.dot(
            jnp.concatenate([h, agg], axis=-1),
            layer["w"],
            preferred_element_type=jnp.float32,
        ) + layer["b"]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def _sage_invd(pg: PartitionedGraph) -> jnp.ndarray:
    return jnp.asarray(
        np.where(
            pg.in_degrees > 0,
            1.0 / np.maximum(pg.in_degrees, 1),
            0.0,
        ).astype(np.float32)
    )


def dist_sage_forward(
    pg: PartitionedGraph,
    shards,
    mesh: Mesh,
    params: list,
    x: jnp.ndarray,  # [D, n_loc, F] sharded on axis 0
    axis: str = "graph",
    plan=None,
) -> jnp.ndarray:
    """GraphSAGE mean-aggregator forward on the sharded mesh; matches the
    single-chip `models/sage.py::sage_forward` on the owned rows."""
    n_loc = pg.n_loc
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    def run(g, x_loc, invd, send_idx, src_slot, params):
        return _sage_local(
            n_loc, use_plan, axis, g, x_loc, invd, send_idx, src_slot,
            params,
        )[None]

    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    invd = jax.device_put(_sage_invd(pg), NamedSharding(mesh, P(axis)))
    return jax.jit(run)(shards, x, invd, send_idx, src_slot, params)


def dist_gat_forward(
    pg: PartitionedGraph,
    shards,
    mesh: Mesh,
    params: list,
    x: jnp.ndarray,  # [D, n_loc, F] sharded on axis 0
    axis: str = "graph",
    negative_slope: float = 0.2,
    plan=None,
) -> jnp.ndarray:
    """GAT forward on the sharded mesh (fused-attention math, see module
    docstring); matches single-chip `gat_forward` to fp tolerance."""
    n_loc = pg.n_loc
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    def run(g, x_loc, send_idx, src_slot, params):
        return _gat_local(
            n_loc, use_plan, axis, negative_slope, g, x_loc, send_idx,
            src_slot, params,
        )[None]

    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    return jax.jit(run)(shards, x, send_idx, src_slot, params)


def _gat_local(
    n_loc, use_plan, axis, negative_slope, g, x_loc, send_idx, src_slot,
    params,
):
    """Per-shard fused-attention GAT forward body (shared by the forward
    and the train step)."""
    esrc = g.csc_srcs[0]
    edst = g.csc_dsts_local[0]
    emask = g.edge_mask[0]
    readv = _make_edge_reader(
        use_plan, axis, esrc, send_idx, src_slot
    )
    readm = _make_mat_reader(
        use_plan, axis, esrc, send_idx, src_slot
    )
    h = x_loc[0]
    n_layers = len(params)
    for i, layer in enumerate(params):
        n_heads = layer["w"].shape[0]
        heads = []
        for hd in range(n_heads):
            hw = jnp.dot(
                h, layer["w"][hd],
                preferred_element_type=jnp.float32,
            )
            s_src = hw @ layer["a_src"][hd]  # [n_loc]
            s_dst = hw @ layer["a_dst"][hd]
            # global max via all_gather-of-scalars (pmax has no JVP rule,
            # which the train step needs); stop_gradient because the
            # stabilizer bound is a per-dst-segment constant that cancels
            # in the normalized ratio — its true gradient is zero
            gmax = jax.lax.stop_gradient(
                jnp.max(
                    jax.lax.all_gather(jnp.max(s_src), axis)
                )
            )
            e_src = readv(s_src)
            ed = s_dst[edst]
            e = jax.nn.leaky_relu(e_src + ed, negative_slope)
            bound = jax.nn.leaky_relu(gmax + ed, negative_slope)
            w = jnp.where(emask, jnp.exp(e - bound), 0.0)
            num = segment_reduce(
                readm(hw) * w[:, None], edst, n_loc, "sum",
                mask=emask[:, None],
            )
            denom = jnp.maximum(
                segment_reduce(w, edst, n_loc, "sum"), 1e-30
            )
            heads.append(num / denom[:, None])
        if i < n_layers - 1:
            h = jax.nn.elu(jnp.concatenate(heads, axis=-1))
        else:
            h = sum(heads) / len(heads)
    return h


# ------------------------------------------------------------- training
def _masked_xent_psum(logits, labels_loc, mask_loc, axis):
    """Global mean masked cross-entropy across the mesh (same loss as
    `parallel/gcn.dist_gcn_train_step_fn`)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels_loc[:, None], axis=-1)[:, 0]
    nll = jnp.where(mask_loc, nll, 0.0)
    total = jax.lax.psum(jnp.sum(nll), axis)
    count = jax.lax.psum(jnp.sum(mask_loc), axis)
    return total / jnp.maximum(count, 1)


def _sgd_momentum(params, opt, grads, lr):
    new_opt = jax.tree_util.tree_map(
        lambda m, dw: 0.9 * m + dw, opt, grads
    )
    new_params = jax.tree_util.tree_map(
        lambda p, m: p - lr * m, params, new_opt
    )
    return new_params, new_opt


def dist_sage_train(
    pg: PartitionedGraph,
    shards,
    mesh: Mesh,
    params: list,
    x: jnp.ndarray,  # [D, n_loc, F] sharded
    labels: jnp.ndarray,  # [D, n_loc] int sharded
    mask: jnp.ndarray,  # [D, n_loc] bool sharded
    steps: int = 1,
    lr: float = 0.05,
    axis: str = "graph",
    plan=None,
):
    """Distributed GraphSAGE training: the shared
    per-shard forward under ``value_and_grad``, pmean'd grads on
    replicated params, momentum SGD — the `parallel/gcn.dist_gcn_train`
    recipe over the SAGE forward.  Returns (params, losses)."""
    n_loc = pg.n_loc
    use_plan = plan is not None
    row = P(axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(row, P(), P(), row, row, row, row, row, row),
        out_specs=(P(), P(), P()),
    )
    def step(g, params, opt, x_loc, lab, msk, invd, send_idx, src_slot):
        def loss_fn(params):
            logits = _sage_local(
                n_loc, use_plan, axis, g, x_loc, invd, send_idx,
                src_slot, params,
            )
            return _masked_xent_psum(logits, lab[0], msk[0], axis)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.pmean(grads, axis)
        new_params, new_opt = _sgd_momentum(params, opt, grads, lr)
        return new_params, new_opt, loss

    repl = NamedSharding(mesh, P())
    params = jax.device_put(params, repl)
    opt = jax.tree_util.tree_map(jnp.zeros_like, params)
    send_idx, src_slot = _plan_args(pg, plan, mesh, row)
    invd = jax.device_put(_sage_invd(pg), NamedSharding(mesh, row))
    jitted = jax.jit(step)
    losses = []
    for _ in range(steps):
        params, opt, loss = jitted(
            shards, params, opt, x, labels, mask, invd, send_idx,
            src_slot,
        )
        losses.append(float(loss))
    return params, losses


def dist_gat_train(
    pg: PartitionedGraph,
    shards,
    mesh: Mesh,
    params: list,
    x: jnp.ndarray,  # [D, n_loc, F] sharded
    labels: jnp.ndarray,  # [D, n_loc] int sharded
    mask: jnp.ndarray,  # [D, n_loc] bool sharded
    steps: int = 1,
    lr: float = 0.05,
    axis: str = "graph",
    negative_slope: float = 0.2,
    plan=None,
):
    """Distributed GAT training: fused-attention
    forward differentiated end-to-end inside shard_map (the stabilizer
    bound is stop_gradient'ed — it cancels per dst segment, so its true
    gradient is zero), pmean'd grads, momentum SGD.  Returns
    (params, losses)."""
    n_loc = pg.n_loc
    use_plan = plan is not None
    row = P(axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(row, P(), P(), row, row, row, row, row),
        out_specs=(P(), P(), P()),
    )
    def step(g, params, opt, x_loc, lab, msk, send_idx, src_slot):
        def loss_fn(params):
            logits = _gat_local(
                n_loc, use_plan, axis, negative_slope, g, x_loc,
                send_idx, src_slot, params,
            )
            return _masked_xent_psum(logits, lab[0], msk[0], axis)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.pmean(grads, axis)
        new_params, new_opt = _sgd_momentum(params, opt, grads, lr)
        return new_params, new_opt, loss

    repl = NamedSharding(mesh, P())
    params = jax.device_put(params, repl)
    opt = jax.tree_util.tree_map(jnp.zeros_like, params)
    send_idx, src_slot = _plan_args(pg, plan, mesh, row)
    jitted = jax.jit(step)
    losses = []
    for _ in range(steps):
        params, opt, loss = jitted(
            shards, params, opt, x, labels, mask, send_idx, src_slot
        )
        losses.append(float(loss))
    return params, losses
