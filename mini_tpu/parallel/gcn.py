"""Distributed GCN over the edge-partitioned graph (GCN training,
edge-partitioned across N >= 2 devices).

Sharding layout: activations row-sharded by the dst-range vertex partition
(`parallel/partition.py`); parameters replicated (psum'd grads).  Each layer
computes the dense H @ W locally, all-gathers the projected feature slab
over the graph axis (the only cross-chip traffic), and reduces its own
in-edges locally.  The boundary-only all-to-all with compute overlap is the
planned refinement of the all-gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mini_tpu.parallel.partition import PartitionedGraph
from mini_tpu.parallel.distributed import DeviceShards
from mini_tpu.ops.segment import segment_reduce


def gcn_norm_arrays(pg: PartitionedGraph):
    """Replicated global inv-sqrt(deg_hat) + per-shard self coefficients.

    deg_hat = in_degree + 1 (matches single-chip `models/gcn.gcn_normalize`).
    """
    deg_hat = np.ones(pg.n_pad, np.float32)
    deg_hat[: pg.n] += np.concatenate(
        [pg.in_degrees.reshape(-1)]
    )[: pg.n]
    inv_sqrt = 1.0 / np.sqrt(deg_hat)
    real = np.arange(pg.n_pad) < pg.n
    self_coeff = np.where(real, 1.0 / deg_hat, 0.0).astype(np.float32)
    return jnp.asarray(inv_sqrt), jnp.asarray(
        self_coeff.reshape(pg.num_shards, pg.n_loc)
    )


def dist_gcn_train_step_fn(
    pg: PartitionedGraph,
    mesh: Mesh,
    axis="graph",
    lr: float = 0.05,
    halo_plan=None,
    overlap: bool = False,
):
    """Build the jitted shard_map training step.

    Returns step(shards, params, opt, x, labels, mask, inv_sqrt, self_coeff)
    -> (params, opt, loss); x/labels/mask/self_coeff are [D, n_loc, ...]
    sharded, params/opt/inv_sqrt replicated.  With ``halo_plan`` (see
    parallel/halo.py) the feature exchange is boundary-only all-to-all
    instead of a full all-gather; ``overlap=True`` additionally splits the
    aggregation so the own-edge part runs while the collective is in
    flight.  ``axis`` may be a ("dcn", "ici") pair for the hierarchical
    2-level exchange on a 2-level mesh.
    """
    from mini_tpu.parallel.halo import exchange_slabs

    n_loc = pg.n_loc
    D = pg.num_shards
    axis_t = axis if isinstance(axis, str) else tuple(axis)
    if halo_plan is not None:
        send_idx_h = jnp.asarray(halo_plan.send_idx)
        src_slot_h = jnp.asarray(halo_plan.src_slot)
        H = halo_plan.halo_width
        if overlap:
            own_slot_h = jnp.asarray(halo_plan.own_slot)
            own_dst_h = jnp.asarray(halo_plan.own_dst)
            own_srcg_h = jnp.asarray(halo_plan.own_src_global)
            own_mask_h = jnp.asarray(halo_plan.own_mask)
            halo_slot_h = jnp.asarray(halo_plan.halo_slot)
            halo_dst_h = jnp.asarray(halo_plan.halo_dst)
            halo_srcg_h = jnp.asarray(halo_plan.halo_src_global)
            halo_mask_h = jnp.asarray(halo_plan.halo_mask)

    def forward(g: DeviceShards, params, x_loc, inv_sqrt, self_c, shard_id):
        esrc = g.csc_srcs[0]
        edst = g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        # symmetric normalization: w_e = inv_sqrt[src] * inv_sqrt[dst]
        dst_global = edst + shard_id * n_loc
        ew = jnp.where(
            emask, inv_sqrt[esrc] * inv_sqrt[dst_global], 0.0
        )
        if halo_plan is not None and overlap:
            ew_own = jnp.where(
                own_mask_h[shard_id],
                inv_sqrt[own_srcg_h[shard_id]]
                * inv_sqrt[own_dst_h[shard_id] + shard_id * n_loc],
                0.0,
            )
            ew_halo = jnp.where(
                halo_mask_h[shard_id],
                inv_sqrt[halo_srcg_h[shard_id]]
                * inv_sqrt[halo_dst_h[shard_id] + shard_id * n_loc],
                0.0,
            )
        h = x_loc
        for i, layer in enumerate(params):
            hw = jnp.dot(h, layer["w"], preferred_element_type=jnp.float32)
            if halo_plan is None:
                hw_full = jax.lax.all_gather(hw, axis_t, tiled=True)
                agg = segment_reduce(
                    hw_full[esrc] * ew[:, None], edst, n_loc, "sum"
                )
            elif overlap:
                out_rows = hw[send_idx_h[shard_id].reshape(-1)].reshape(
                    D, H, -1
                )
                halo = exchange_slabs(out_rows, axis_t)
                # own-edge aggregation reads only hw: no dependency on
                # the collective, XLA overlaps it with the exchange
                agg = segment_reduce(
                    hw[own_slot_h[shard_id]] * ew_own[:, None],
                    own_dst_h[shard_id], n_loc, "sum",
                )
                agg = agg + segment_reduce(
                    halo.reshape(D * H, -1)[halo_slot_h[shard_id]]
                    * ew_halo[:, None],
                    halo_dst_h[shard_id], n_loc, "sum",
                )
            else:
                out_rows = hw[send_idx_h[shard_id].reshape(-1)].reshape(
                    D, H, -1
                )
                halo = exchange_slabs(out_rows, axis_t)
                buf = jnp.concatenate([halo.reshape(D * H, -1), hw], 0)
                agg = segment_reduce(
                    buf[src_slot_h[shard_id]] * ew[:, None],
                    edst, n_loc, "sum",
                )
            h = agg + self_c[:, None] * hw + layer["b"]
            if i < len(params) - 1:
                h = jax.nn.relu(h)
        return h

    def step(g, params, opt, x, labels, mask, inv_sqrt, self_c):
        shard_id = jax.lax.axis_index(axis_t)

        def loss_fn(params):
            logits = forward(
                g, params, x[0], inv_sqrt, self_c[0], shard_id
            )
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, labels[0][:, None], axis=-1)[
                :, 0
            ]
            nll = jnp.where(mask[0], nll, 0.0)
            total = jax.lax.psum(jnp.sum(nll), axis_t)
            count = jax.lax.psum(jnp.sum(mask[0]), axis_t)
            return total / jnp.maximum(count, 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.pmean(grads, axis_t)  # params replicated
        new_opt = jax.tree_util.tree_map(
            lambda m, dw: 0.9 * m + dw, opt, grads
        )
        new_params = jax.tree_util.tree_map(
            lambda p, m: p - lr * m, params, new_opt
        )
        return new_params, new_opt, loss

    row = P(axis_t)
    sharded = functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            row,  # prefix spec: every DeviceShards leaf
            P(),
            P(),
            row,
            row,
            row,
            P(),
            row,
        ),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(sharded(step))


def dist_gcn_train(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    params,
    x: jnp.ndarray,  # [D, n_loc, F] sharded
    labels: jnp.ndarray,  # [D, n_loc] sharded
    mask: jnp.ndarray,  # [D, n_loc] sharded
    steps: int = 1,
    lr: float = 0.05,
    axis="graph",
    halo_plan=None,
    overlap: bool = False,
):
    """Run ``steps`` distributed training steps; returns (params, losses)."""
    axis_t = axis if isinstance(axis, str) else tuple(axis)
    inv_sqrt, self_c = gcn_norm_arrays(pg)
    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(axis_t))
    params = jax.device_put(params, repl)
    opt = jax.tree_util.tree_map(jnp.zeros_like, params)
    inv_sqrt = jax.device_put(inv_sqrt, repl)
    self_c = jax.device_put(self_c, row)
    step = dist_gcn_train_step_fn(
        pg, mesh, axis=axis, lr=lr, halo_plan=halo_plan, overlap=overlap
    )
    losses = []
    for _ in range(steps):
        params, opt, loss = step(
            shards, params, opt, x, labels, mask, inv_sqrt, self_c
        )
        losses.append(float(loss))
    return params, losses
