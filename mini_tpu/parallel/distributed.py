"""Multi-device execution: `shard_map` over a `jax.sharding.Mesh`.

The communication backend is XLA collectives (NCCL on GPUs) — `all_gather`
/ `psum` / `all_to_all` inside `shard_map` — not a hand-written comm layer
(SURVEY.md §5).  The pattern for every operator: per-dst state and edges are
shard-local (see `partition.py`), so the only cross-chip traffic is

* the frontier bitmap (BFS/SSSP: n bits, all-gathered per iteration), or
* the feature slab (SpMM/GCN: rows of H needed for remote sources).

Every traversal here takes an optional ``plan`` (a
`mini_tpu.parallel.halo.HaloPlan`): with it, the per-iteration exchange is
**boundary-only** — each shard sends only the rows other shards' in-edges
actually read (one all-to-all of D x H slabs, H = max boundary rows)
instead of all-gathering the full n-vector; edges then read from the
[halo | own] buffer through the plan's static ``src_slot`` map.  Without a
plan the v1 full-slab ``all_gather`` path is used (kept for comparison).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mini_tpu.parallel.partition import PartitionedGraph
from mini_tpu.ops.segment import segment_reduce


def make_mesh(num_devices: int | None = None, axis: str = "graph") -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh_2level(
    num_slices: int,
    per_slice: int | None = None,
    axes: tuple[str, str] = ("dcn", "ici"),
) -> Mesh:
    """2-level mesh: ``num_slices`` groups of ``per_slice`` devices.
    Consecutive device blocks form a group; collectives over ``axes[1]``
    stay within a group, over ``axes[0]`` they cross groups.  Graph
    shards flatten as
    ``slice_idx * per_slice + chip_idx`` (``P(axes)`` block order)."""
    devices = jax.devices()
    if per_slice is None:
        per_slice = len(devices) // num_slices
    devices = devices[: num_slices * per_slice]
    return Mesh(
        np.array(devices).reshape(num_slices, per_slice), axes
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceShards:
    """Device-side shard arrays; leading axis sharded over the mesh."""

    col_offsets: jnp.ndarray
    csc_srcs: jnp.ndarray
    csc_dsts_local: jnp.ndarray
    csc_weights: jnp.ndarray
    edge_mask: jnp.ndarray
    in_degrees: jnp.ndarray
    out_degrees: jnp.ndarray


def shard_to_mesh(
    pg: PartitionedGraph, mesh: Mesh, axis="graph"
) -> DeviceShards:
    """``axis`` may be one mesh axis name or a ("dcn", "ici") pair — the
    leading shard dim then spans both (flat id = dcn_idx * D_ici + ici)."""
    spec = NamedSharding(
        mesh, P(axis if isinstance(axis, str) else tuple(axis))
    )

    def put(a):
        return jax.device_put(jnp.asarray(a), spec)

    return DeviceShards(
        col_offsets=put(pg.col_offsets),
        csc_srcs=put(pg.csc_srcs),
        csc_dsts_local=put(pg.csc_dsts_local),
        csc_weights=put(pg.csc_weights),
        edge_mask=put(pg.edge_mask),
        in_degrees=put(pg.in_degrees),
        out_degrees=put(pg.out_degrees),
    )


def _plan_args(pg: PartitionedGraph, plan, mesh, spec):
    """Device-put the halo plan's static index maps (or 1-wide dummies when
    no plan is given; the traced branch that would read them is dead)."""
    D = pg.num_shards
    if plan is None:
        send_idx = np.zeros((D, 1, 1), np.int32)
        src_slot = np.zeros((D, 1), np.int32)
    else:
        send_idx, src_slot = plan.send_idx, plan.src_slot
    put = NamedSharding(mesh, spec)
    return (
        jax.device_put(jnp.asarray(send_idx), put),
        jax.device_put(jnp.asarray(src_slot), put),
    )


def _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot):
    """Per-iteration exchange: returns read(vals_loc) -> per-edge values.

    With a plan: gather this shard's boundary rows, one all-to-all of
    [D, H] slabs (`halo.exchange_slabs`), read edges from [halo | own]
    through the static src_slot map — wire traffic D*H rows.  Without:
    all-gather the full n-vector and read by global source id.
    """
    from mini_tpu.parallel.halo import exchange_slabs

    if not use_plan:
        def read(vals_loc):
            full = jax.lax.all_gather(vals_loc, axis, tiled=True)
            return full[esrc]
        return read

    D, H = send_idx.shape[1], send_idx.shape[2]

    def read(vals_loc):
        rows = vals_loc[send_idx[0].reshape(-1)].reshape(D, H, 1)
        halo = exchange_slabs(rows, axis)  # [D, H, 1] sender-major
        buf = jnp.concatenate([halo.reshape(D * H), vals_loc])
        return buf[src_slot[0]]

    return read


def make_dist_bfs(
    pg: PartitionedGraph,
    mesh: Mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Build-once factory: returns ``call(shards, src) -> (labels, preds)``
    with the shard_map program jitted a single time (repeat calls don't
    retrace — required for honest weak-scaling timing)."""
    n_pad, n_loc = pg.n_pad, pg.n_loc
    D = pg.num_shards
    if max_iter is None:
        max_iter = n_pad
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis),  # DeviceShards pytree (spec broadcasts over leaves)
            P(axis), P(axis), P(axis), P(axis), P(axis),
        ),
        out_specs=(P(axis), P(axis)),
    )
    def run(g, labels_loc, preds_loc, vis0, send_idx, src_slot):
        esrc, edst = g.csc_srcs[0], g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)

        def body(state):
            labels, preds, vis, it = state
            unvisited = labels == -1
            active = read(vis) & unvisited[edst] & emask
            new_vis = segment_reduce(active, edst, n_loc, "or")
            new_pred = segment_reduce(
                esrc, edst, n_loc, "min", mask=active
            ).astype(jnp.int32)
            labels = jnp.where(new_vis, it + 1, labels)
            preds = jnp.where(new_vis, new_pred, preds)
            return labels, preds, new_vis, it + 1

        def cond(state):
            _, _, vis, it = state
            alive = jax.lax.psum(
                jnp.any(vis).astype(jnp.int32), axis
            )
            return (alive > 0) & (it < max_iter)

        labels, preds, _, _ = jax.lax.while_loop(
            cond, body,
            (labels_loc[0], preds_loc[0], vis0[0], jnp.int32(0)),
        )
        return labels[None], preds[None]

    run_jit = jax.jit(run)
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    spec = NamedSharding(mesh, P(axis))

    def call(shards: DeviceShards, src: int):
        labels0 = jnp.full((D, n_loc), -1, jnp.int32)
        labels0 = labels0.at[src // n_loc, src % n_loc].set(0)
        preds0 = jnp.full((D, n_loc), -1, jnp.int32)
        vis0 = jnp.zeros((D, n_loc), jnp.bool_)
        vis0 = vis0.at[src // n_loc, src % n_loc].set(True)
        labels, preds = run_jit(
            shards,
            jax.device_put(labels0, spec),
            jax.device_put(preds0, spec),
            jax.device_put(vis0, spec),
            send_idx, src_slot,
        )
        return labels.reshape(-1), preds.reshape(-1)

    return call


def dist_bfs(
    pg: PartitionedGraph,
    shards: DeviceShards,
    src: int,
    mesh: Mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed BFS: labels sharded by dst range; per iteration each shard
    reduces its local in-edges against the exchanged frontier — boundary-only
    slabs with a ``plan`` (HaloPlan), full all-gather without."""
    return make_dist_bfs(pg, mesh, axis, max_iter, plan)(shards, src)


def dist_sssp(
    pg: PartitionedGraph,
    shards: DeviceShards,
    src: int,
    mesh: Mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed Bellman-Ford: distances sharded by dst range; per
    iteration each shard relaxes its local in-edges against the exchanged
    improved-distance vector (f32 segmented min — deterministic and
    bitwise-equal to the single-chip path).  ``plan`` switches the
    exchange to boundary-only slabs."""
    n_pad, n_loc = pg.n_pad, pg.n_loc
    D = pg.num_shards
    if max_iter is None:
        max_iter = n_pad
    inf = jnp.float32(jnp.inf)
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def run(g, dist_loc, masked0, send_idx, src_slot):
        esrc = g.csc_srcs[0]
        edst = g.csc_dsts_local[0]
        ew = g.csc_weights[0]
        emask = g.edge_mask[0]
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)

        def body(state):
            dist, masked, it = state
            cand = jnp.where(emask, read(masked) + ew, inf)
            best = segment_reduce(cand, edst, n_loc, "min")
            improved = best < dist
            dist = jnp.minimum(dist, best)
            masked = jnp.where(improved, dist, inf)
            return dist, masked, it + 1

        def cond(state):
            _, masked, it = state
            alive = jax.lax.psum(
                jnp.any(jnp.isfinite(masked)).astype(jnp.int32), axis
            )
            return (alive > 0) & (it < max_iter)

        dist, _, _ = jax.lax.while_loop(
            cond, body, (dist_loc[0], masked0[0], jnp.int32(0))
        )
        return dist[None]

    dist0 = jnp.full((D, n_loc), inf, jnp.float32)
    dist0 = dist0.at[src // n_loc, src % n_loc].set(0.0)
    masked0 = jnp.full((D, n_loc), inf, jnp.float32)
    masked0 = masked0.at[src // n_loc, src % n_loc].set(0.0)
    spec = NamedSharding(mesh, P(axis))
    dist0 = jax.device_put(dist0, spec)
    masked0 = jax.device_put(masked0, spec)
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    return jax.jit(run)(
        shards, dist0, masked0, send_idx, src_slot
    ).reshape(-1)


def make_dist_spmm(
    pg: PartitionedGraph,
    mesh: Mesh,
    axis: str = "graph",
    with_weights: bool = False,
):
    """Build-once factory for the all-gather distributed pull-SpMM:
    returns ``call(shards, x[, weights]) -> [D, n_loc, F]``."""
    n_loc = pg.n_loc

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis),
            P(axis),
            P(axis) if with_weights else P(),
        ),
        out_specs=P(axis),
    )
    def run(g, x_loc, w):
        x_full = jax.lax.all_gather(x_loc[0], axis, tiled=True)  # [n_pad, F]
        esrc, edst = g.csc_srcs[0], g.csc_dsts_local[0]
        ew = (w[0] if with_weights else g.csc_weights[0])
        msgs = x_full[esrc] * ew[:, None]
        out = segment_reduce(
            msgs, edst, n_loc, "sum", mask=g.edge_mask[0][:, None]
        )
        return out[None]

    run_jit = jax.jit(run)

    def call(shards, x, weights=None):
        w_arg = weights if weights is not None else jnp.zeros((1,))
        return run_jit(shards, x, w_arg)

    return call


def dist_spmm(
    pg: PartitionedGraph,
    shards: DeviceShards,
    x: jnp.ndarray,  # [D, n_loc, F] sharded on axis 0
    mesh: Mesh,
    axis: str = "graph",
    weights: jnp.ndarray | None = None,  # [D, m_loc] sharded, CSC order
) -> jnp.ndarray:
    """Distributed pull-SpMM: all-gather the feature slab, local gather +
    segment-sum into the owned dst rows.  Returns [D, n_loc, F] sharded."""
    return make_dist_spmm(pg, mesh, axis, weights is not None)(
        shards, x, weights
    )


def dist_pagerank(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    axis: str = "graph",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
    plan=None,
):
    """Distributed standard PageRank: ranks sharded by dst range; per
    iteration each shard sums in-neighbor contributions locally after one
    exchange of the (rank/out_degree) contribution vector — the direct
    distribution of the single-chip ``algorithms/pagerank.py`` standard
    variant (same update, same freeze-on-convergence semantics).  ``plan``
    switches the exchange to boundary-only slabs."""
    n_pad, n_loc, n = pg.n_pad, pg.n_loc, pg.n
    D = pg.num_shards
    inv_n = 1.0 / n
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    def run(g, ranks_loc, real_loc, send_idx, src_slot):
        esrc, edst = g.csc_srcs[0], g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        out_deg = g.out_degrees[0].astype(jnp.float32)
        real = real_loc[0]
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)

        def body(state):
            ranks, active, it = state
            contrib = jnp.where(out_deg > 0, ranks / out_deg, 0.0)
            reduced = segment_reduce(
                jnp.where(emask, read(contrib), 0.0), edst, n_loc,
                "sum",
            )
            dangling = jax.lax.psum(
                jnp.sum(jnp.where(real & (out_deg == 0), ranks, 0.0)),
                axis,
            )
            new = (1.0 - damping) * inv_n + damping * (
                reduced + dangling * inv_n
            )
            new = jnp.where(real, new, 0.0)
            new = jnp.where(active, new, ranks)
            moved = jnp.abs(new - ranks) > tol_rel * jnp.abs(ranks)
            return new, active & moved & real, it + 1

        def cond(state):
            _, active, it = state
            return (
                jax.lax.psum(jnp.sum(active.astype(jnp.int32)), axis) > 0
            ) & (it < max_iter)

        ranks0 = jnp.where(real, jnp.float32(inv_n), 0.0)
        ranks, _, it = jax.lax.while_loop(
            cond, body, (ranks0, real, jnp.int32(0))
        )
        return ranks[None], it

    real = (jnp.arange(n_pad) < n).reshape(D, n_loc)
    spec = NamedSharding(mesh, P(axis))
    ranks0 = jax.device_put(jnp.zeros((D, n_loc), jnp.float32), spec)
    real = jax.device_put(real, spec)
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    ranks, it = jax.jit(run)(shards, ranks0, real, send_idx, src_slot)
    return ranks.reshape(-1), it


def dist_cc(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed connected components (weakly connected for directed
    input): min-label propagation over in-edges with the label vector
    exchanged per round (boundary-only with ``plan``).  Converges to the
    same fixpoint as the single-chip ``algorithms/cc.py`` (min vertex id
    per component)."""
    n_pad, n_loc, n = pg.n_pad, pg.n_loc, pg.n
    D = pg.num_shards
    if max_iter is None:
        max_iter = n_pad
    use_plan = plan is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    def run(g, labels_loc, send_idx, src_slot):
        esrc, edst = g.csc_srcs[0], g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        big = jnp.int32(jnp.iinfo(jnp.int32).max)
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)

        def body(state):
            labels, _, it = state
            nb_min = segment_reduce(
                jnp.where(emask, read(labels), big), edst, n_loc, "min"
            )
            new = jnp.minimum(labels, nb_min)
            changed = jax.lax.psum(
                jnp.sum((new != labels).astype(jnp.int32)), axis
            )
            return new, changed, it + 1

        def cond(state):
            _, changed, it = state
            return (changed > 0) & (it < max_iter)

        labels, _, it = jax.lax.while_loop(
            cond, body, (labels_loc[0], jnp.int32(1), jnp.int32(0))
        )
        return labels[None], it

    shard_id = jnp.arange(D, dtype=jnp.int32)[:, None]
    labels0 = shard_id * n_loc + jnp.arange(n_loc, dtype=jnp.int32)[None, :]
    spec = NamedSharding(mesh, P(axis))
    labels0 = jax.device_put(labels0, spec)
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    labels, it = jax.jit(run)(shards, labels0, send_idx, src_slot)
    return labels.reshape(-1), it


def dist_coloring(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    axis: str = "graph",
    seed: int = 0,
    hashes_per_round: int = 16,
    max_iter: int | None = None,
    plan=None,
):
    """Distributed Jones-Plassmann hash coloring, bitwise-matching the
    single-chip fast path (`algorithms/coloring._coloring_fast_impl`,
    undirected graphs): priorities derive from STATIC GLOBAL vertex ids
    (``mix(id ^ salt_round, j)``), so the only exchanged state per round is
    the one-bit uncolored vector (boundary slabs with ``plan``).  Each of
    the K hash orders contributes a min- and a max-claim blocker test,
    reduced as 2K boolean ORs over each vertex's in-edges."""
    import jax.random as jrandom

    from mini_tpu.algorithms.coloring import _mix

    n_pad, n_loc, n = pg.n_pad, pg.n_loc, pg.n
    D = pg.num_shards
    K = int(hashes_per_round)
    if max_iter is None:
        max_iter = max(2 * n, 64)
    use_plan = plan is not None
    key = jrandom.PRNGKey(seed)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    def run(g, colors_loc, send_idx, src_slot):
        esrc = g.csc_srcs[0]
        edst = g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)
        sidx = jax.lax.axis_index(axis)
        edst_global = (edst + sidx * n_loc).astype(jnp.uint32)
        esrc_u = esrc.astype(jnp.uint32)
        real = (jnp.arange(n_loc) + sidx * n_loc) < n

        def body(state):
            colors, it = state
            salt = jrandom.bits(jrandom.fold_in(key, it), (), jnp.uint32)
            uncolored = (colors == 0) & real
            unc_e = read(uncolored) & emask
            new_colors = jnp.zeros(n_loc, jnp.int32)
            for j in range(K):
                pe = _mix(esrc_u ^ salt, j)
                po = _mix(edst_global ^ salt, j)
                blocked_min = segment_reduce(
                    unc_e & (pe <= po), edst, n_loc, "or"
                )
                blocked_max = segment_reduce(
                    unc_e & (pe >= po), edst, n_loc, "or"
                )
                free = uncolored & (new_colors == 0)
                is_min = free & ~blocked_min
                is_max = free & ~blocked_max & ~is_min
                base = 2 * K * it + 2 * j
                new_colors = jnp.where(is_min, base + 1, new_colors)
                new_colors = jnp.where(is_max, base + 2, new_colors)
            colors = jnp.where(new_colors > 0, new_colors, colors)
            return colors, it + 1

        def cond(state):
            colors, it = state
            left = jax.lax.psum(
                jnp.sum(((colors == 0) & real).astype(jnp.int32)), axis
            )
            return (left > 0) & (it < max_iter)

        colors, it = jax.lax.while_loop(
            cond, body, (colors_loc[0], jnp.int32(0))
        )
        return colors[None], it

    colors0 = jax.device_put(
        jnp.zeros((D, n_loc), jnp.int32), NamedSharding(mesh, P(axis))
    )
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    colors, it = jax.jit(run)(shards, colors0, send_idx, src_slot)
    return colors.reshape(-1), it


def dist_kcore(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed k-core via the h-index fixpoint (undirected graphs;
    matches the single-chip `algorithms/kcore._kcore_hindex_impl`
    bitwise — the synchronous fixpoint iteration is partition-invariant).
    Per round each shard exchanges its h vector (boundary slabs with
    ``plan``), sorts its local in-edges by (dst, h desc), and counts
    positions whose value >= within-segment rank."""
    n_pad, n_loc, n = pg.n_pad, pg.n_loc, pg.n
    D = pg.num_shards
    m_loc = pg.m_loc
    if max_iter is None:
        max_iter = n_pad
    use_plan = plan is not None
    maxd = int(pg.out_degrees.max(initial=0))
    bits_v = max(1, (maxd + 1).bit_length())

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    def run(g, h0_loc, send_idx, src_slot):
        esrc = g.csc_srcs[0]
        edst = g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)
        idx = jnp.arange(m_loc, dtype=jnp.int32)

        def h_step(h):
            val = jnp.where(emask, read(h), -1)  # pads sort last, never count
            key = edst * jnp.int32(1 << bits_v) + (jnp.int32(maxd) - val)
            skey = jax.lax.sort(key)
            s_dst = skey // jnp.int32(1 << bits_v)
            sval = jnp.int32(maxd) - (skey & jnp.int32((1 << bits_v) - 1))
            rank1 = idx - jnp.searchsorted(s_dst, s_dst).astype(jnp.int32) + 1
            ok = ((sval >= rank1) & (sval >= 0)).astype(jnp.int32)
            return segment_reduce(ok, s_dst, n_loc, "sum",
                                  indices_are_sorted=True)

        def body(state):
            h, _, it = state
            newh = h_step(h)
            changed = jax.lax.psum(
                jnp.sum((newh != h).astype(jnp.int32)), axis
            )
            return newh, changed, it + 1

        def cond(state):
            _, changed, it = state
            return (changed > 0) & (it < max_iter)

        h, _, it = jax.lax.while_loop(
            cond, body, (h0_loc[0], jnp.int32(1), jnp.int32(0))
        )
        return h[None], it

    h0 = jax.device_put(
        jnp.asarray(pg.out_degrees.astype(np.int32)),
        NamedSharding(mesh, P(axis)),
    )
    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    h, it = jax.jit(run)(shards, h0, send_idx, src_slot)
    return h.reshape(-1), it


def dist_lspar(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh: Mesh,
    axis: str = "graph",
    prime: int = 999983,
    e: float = 0.5,
    seed: int = 0,
    plan=None,
):
    """Distributed L-Spar sparsification (undirected graphs).

    On an undirected (doubled) graph the dst-partitioned CSC segment of a
    vertex IS its adjacency list in the same neighbor-sorted order as the
    single-chip CSR form, so every stage is shard-local except ONE
    exchange: the minwise-hash vector (boundary slabs with ``plan``).
    Per shard: (1) minwise[v] = masked min over the segment of
    hash(src) — the universal hashes derive from STATIC global ids
    (`/root/reference/gunrock/src/lspar/lspar_problem.hxx:95-99`) so no
    values move; (2) exchange minwise; (3) binary sims + the prefix-count
    ranks of the single-chip re-design (`algorithms/lspar.py`), all
    within local segments.  Returns ([D, m_loc] selected mask over the
    partitioned CSC edges, total count) — edge (u -> v) selected here iff
    the single-chip run selects CSR edge (v -> u) (same adjacency, same
    stable rank).
    """
    from mini_tpu.algorithms.lspar import is_prime

    if not is_prime(prime):
        raise ValueError(f"{prime} is not prime")
    n_loc = pg.n_loc
    m_loc = pg.m_loc
    use_plan = plan is not None
    INT_MAX = jnp.iinfo(jnp.int32).max

    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)
    b = rng.randint(0, prime)
    idx = np.arange(pg.n_pad, dtype=np.int64)
    hashs = jnp.asarray(((b + a * idx) % prime).astype(np.int32))
    # thresholds in f64 on host exactly like the single-chip entry point
    thr = jnp.asarray(
        np.floor(
            np.power(pg.out_degrees.astype(np.float64), e)
        ).astype(np.int32)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
    )
    def run(g, hashs_full, thr_loc, send_idx, src_slot):
        esrc = g.csc_srcs[0]
        edst = g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        off = g.col_offsets[0].astype(jnp.int32)
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot)

        h_e = jnp.where(emask, hashs_full[esrc], INT_MAX)
        minwise = segment_reduce(h_e, edst, n_loc, "min")
        mw_src_e = read(minwise)
        sims = (emask & (mw_src_e == minwise[edst])).astype(jnp.int32)

        # stable (sim desc) rank via prefix counts within local segments
        c1 = jnp.cumsum(sims)
        c1_ext = jnp.concatenate([jnp.zeros(1, jnp.int32), c1])
        start_c1 = c1_ext[off[:-1]]
        n1 = c1_ext[off[1:]] - start_c1
        p1 = (c1 - sims) - start_c1[edst]
        local = jnp.arange(m_loc, dtype=jnp.int32) - off[:-1][edst]
        rank = jnp.where(sims == 1, p1, n1[edst] + (local - p1))
        sel = (rank < thr_loc[0][edst]) & emask
        cnt = jax.lax.psum(jnp.sum(sel.astype(jnp.int32)), axis)
        return sel[None], sims[None], cnt

    send_idx, src_slot = _plan_args(pg, plan, mesh, P(axis))
    thr_sh = jax.device_put(thr, NamedSharding(mesh, P(axis)))
    sel, sims, cnt = jax.jit(run)(shards, hashs, thr_sh, send_idx,
                                  src_slot)
    return sel, sims, cnt
