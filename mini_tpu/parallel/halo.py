"""Boundary (halo) feature exchange — the all-to-all refinement of the
all-gather slab exchange: boundary frontier/feature slabs move all-to-all
through XLA collectives (NCCL on GPUs), overlapped with local segmented
aggregation.

Host side (once per graph): for every shard pair (owner t -> consumer s),
the set of t's rows that s's in-edges read is static.  We precompute

* ``send_idx[t, s, H]``: local row ids shard t sends to shard s (padded),
* ``src_slot[s, m_loc]``: for each of s's edges, the position of its source
  row in s's receive buffer (halo slabs, t-major) or in s's own rows.

Device side per SpMM: each shard gathers its send rows, one
``all_to_all`` moves the halo slabs, and the local segmented aggregation
reads from [halo | own] — total wire traffic is the boundary set, not the
full feature matrix.

Two refinements on top of the basic exchange:

* **Collective/compute overlap** (``overlap=True``): edges are split
  host-side into *own* (source row lives on this shard) and *halo*
  (source row arrives in the exchange).  The own-edge aggregation reads
  only local rows, so it has no data dependency on the ``all_to_all`` —
  XLA's latency-hiding scheduler runs it while the collective is in
  flight; only the (much smaller) halo-edge aggregation waits.
* **Hierarchical 2-level exchange** (``axes=("dcn", "ici")``): on a
  two-level mesh (groups of devices) the flat D-way all-to-all is
  replaced by an all-to-all over the group axis (messages bundled per
  group) then one within each group, reshaping the sender-major slab
  layout in between.  Same rows moved, but cross-group traffic goes in
  ``D_dcn`` bundled messages instead of ``D`` point-to-point sends.  One
  host of all-to-all linked GPUs has no slow tier; the flat exchange is
  the one it uses.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mini_tpu.parallel.partition import PartitionedGraph
from mini_tpu.parallel.distributed import DeviceShards
from mini_tpu.ops.segment import segment_reduce
from mini_tpu.graph.csr import _round_up


@dataclasses.dataclass
class HaloPlan:
    """Host-side exchange plan; arrays stack on the shard axis."""

    halo_width: int  # H: max rows any shard sends to any other
    send_idx: np.ndarray  # int32[D, D, H]: [sender t, receiver s, slot]
    send_mask: np.ndarray  # bool[D, D, H]
    src_slot: np.ndarray  # int32[D, m_loc]: buffer position per edge
    boundary_rows: int  # total real (unpadded) halo rows
    # split-edge layout for collective/compute overlap (own = source row
    # on this shard; halo = source row arrives in the exchange).  Pad
    # entries carry weight 0 and slot/dst 0.
    m_own: int = 0
    m_halo: int = 0
    own_slot: np.ndarray | None = None  # int32[D, m_own] local row id
    own_dst: np.ndarray | None = None  # int32[D, m_own] local dst
    own_w: np.ndarray | None = None  # float32[D, m_own]
    own_src_global: np.ndarray | None = None  # int32[D, m_own]
    own_mask: np.ndarray | None = None  # bool[D, m_own]
    halo_slot: np.ndarray | None = None  # int32[D, m_halo] pos in halo buf
    halo_dst: np.ndarray | None = None  # int32[D, m_halo]
    halo_w: np.ndarray | None = None  # float32[D, m_halo]
    halo_src_global: np.ndarray | None = None  # int32[D, m_halo]
    halo_mask: np.ndarray | None = None  # bool[D, m_halo]


def build_halo_plan(pg: PartitionedGraph, h_multiple: int = 8) -> HaloPlan:
    D, n_loc, m_loc = pg.num_shards, pg.n_loc, pg.m_loc
    needed: list[list[np.ndarray]] = []  # needed[s][t] = t's local rows
    total_boundary = 0
    for s in range(D):
        em = pg.edge_mask[s]
        srcs = np.unique(pg.csc_srcs[s][em])
        per_owner = []
        for t in range(D):
            if t == s:
                per_owner.append(np.zeros(0, np.int32))
                continue
            rows = srcs[(srcs >= t * n_loc) & (srcs < (t + 1) * n_loc)]
            per_owner.append((rows - t * n_loc).astype(np.int32))
            total_boundary += len(rows)
        needed.append(per_owner)

    H = max(
        (len(needed[s][t]) for s in range(D) for t in range(D)), default=0
    )
    H = _round_up(max(H, 1), h_multiple)

    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    # position lookup: for consumer s, owner t, global src -> halo slot
    src_slot = np.zeros((D, m_loc), np.int32)
    for s in range(D):
        for t in range(D):
            rows = needed[s][t]
            send_idx[t, s, : len(rows)] = rows
            send_mask[t, s, : len(rows)] = True
        # map each edge's source to its buffer position:
        # halo slabs are t-major: slot = t * H + rank(row in needed[s][t]);
        # own rows sit after the halo: D * H + local_row
        em = pg.edge_mask[s]
        gsrc = pg.csc_srcs[s]
        owner = np.clip(gsrc // n_loc, 0, D - 1)
        slot = np.zeros(m_loc, np.int64)
        own = owner == s
        slot[own] = D * H + (gsrc[own] - s * n_loc)
        for t in range(D):
            if t == s:
                continue
            sel = (owner == t) & em
            if not sel.any():
                continue
            ranks = np.searchsorted(needed[s][t], gsrc[sel] - t * n_loc)
            slot[sel] = t * H + ranks
        slot[~em] = D * H  # ghost edges read own row 0 (weight 0 anyway)
        src_slot[s] = slot.astype(np.int32)

    # split-edge layout (own vs halo) for collective/compute overlap
    own_sel = [
        pg.edge_mask[s]
        & (pg.csc_srcs[s] >= s * n_loc)
        & (pg.csc_srcs[s] < (s + 1) * n_loc)
        for s in range(D)
    ]
    halo_sel = [pg.edge_mask[s] & ~own_sel[s] for s in range(D)]
    m_own = _round_up(max(int(o.sum()) for o in own_sel) or 1, 8)
    m_halo = _round_up(max(int(h.sum()) for h in halo_sel) or 1, 8)
    own_slot = np.zeros((D, m_own), np.int32)
    own_dst = np.zeros((D, m_own), np.int32)
    own_w = np.zeros((D, m_own), np.float32)
    own_srcg = np.zeros((D, m_own), np.int32)
    own_mask = np.zeros((D, m_own), bool)
    halo_slot = np.zeros((D, m_halo), np.int32)
    halo_dst = np.zeros((D, m_halo), np.int32)
    halo_w = np.zeros((D, m_halo), np.float32)
    halo_srcg = np.zeros((D, m_halo), np.int32)
    halo_mask = np.zeros((D, m_halo), bool)
    for s in range(D):
        o, hsel = own_sel[s], halo_sel[s]
        no, nh = int(o.sum()), int(hsel.sum())
        own_slot[s, :no] = pg.csc_srcs[s][o] - s * n_loc
        own_dst[s, :no] = pg.csc_dsts_local[s][o]
        own_w[s, :no] = pg.csc_weights[s][o]
        own_srcg[s, :no] = pg.csc_srcs[s][o]
        own_mask[s, :no] = True
        halo_slot[s, :nh] = src_slot[s][hsel]  # positions in the halo buf
        halo_dst[s, :nh] = pg.csc_dsts_local[s][hsel]
        halo_w[s, :nh] = pg.csc_weights[s][hsel]
        halo_srcg[s, :nh] = pg.csc_srcs[s][hsel]
        halo_mask[s, :nh] = True

    return HaloPlan(
        halo_width=H,
        send_idx=send_idx,
        send_mask=send_mask,
        src_slot=src_slot,
        boundary_rows=total_boundary,
        m_own=m_own,
        m_halo=m_halo,
        own_slot=own_slot,
        own_dst=own_dst,
        own_w=own_w,
        own_src_global=own_srcg,
        own_mask=own_mask,
        halo_slot=halo_slot,
        halo_dst=halo_dst,
        halo_w=halo_w,
        halo_src_global=halo_srcg,
        halo_mask=halo_mask,
    )


def exchange_slabs(out_rows: jnp.ndarray, axis) -> jnp.ndarray:
    """Move per-target slabs to their owners inside ``shard_map``.

    ``out_rows`` is [D, H, F] target-major on every shard; the result is
    [D, H, F] *sender*-major.  ``axis`` is either one mesh axis name (flat
    D-way ``all_to_all``) or a ("dcn", "ici") pair — then the exchange is
    hierarchical: one all-to-all over the group axis moving per-group
    super-slabs, one over the within-group axis redistributing inside
    each group.  Flat target/sender ids are
    ``dcn_idx * D_ici + ici_idx``, matching ``shard_map`` block order for
    ``P(("dcn", "ici"))``."""
    if isinstance(axis, str):
        return jax.lax.all_to_all(
            out_rows, axis, split_axis=0, concat_axis=0, tiled=True
        )
    a_dcn, a_ici = axis
    Dd = jax.lax.axis_size(a_dcn)
    Di = jax.lax.axis_size(a_ici)
    _, H, F = out_rows.shape
    x = out_rows.reshape(Dd, Di, H, F)  # [target dcn, target ici, H, F]
    # phase 1 (group axis): super-slab [Di, H, F] to each group; axis 0
    # becomes the SENDER dcn index
    x = jax.lax.all_to_all(x, a_dcn, split_axis=0, concat_axis=0,
                           tiled=True)
    # phase 2 (within-group axis): redistribute target-ici rows within
    # the group; axis 1 becomes the SENDER ici index
    x = jax.lax.all_to_all(x, a_ici, split_axis=1, concat_axis=1,
                           tiled=True)
    return x.reshape(Dd * Di, H, F)  # sender-flat-major


def make_halo_spmm(
    pg: PartitionedGraph,
    plan: HaloPlan,
    mesh: Mesh,
    axis="graph",
    overlap: bool = False,
):
    """Build-once factory for the boundary-exchange pull-SpMM: returns
    ``call(shards, x) -> [D, n_loc, F]`` with the plan arrays device-put
    and the shard_map program jitted a single time."""
    n_loc = pg.n_loc
    D = pg.num_shards
    H = plan.halo_width
    spec = P(axis) if isinstance(axis, str) else P(tuple(axis))
    put = NamedSharding(mesh, spec)

    if overlap:

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(spec,) * 8,
            out_specs=spec,
        )
        def run(send_idx, own_slot, own_dst, own_w, halo_slot, halo_dst,
                halo_w, x_loc):
            xs = x_loc[0]  # [n_loc, F]
            out_rows = xs[send_idx[0].reshape(-1)].reshape(D, H, -1)
            halo = exchange_slabs(out_rows, axis)
            # local aggregation first: reads only xs, overlaps with the
            # in-flight collective (pad entries carry weight 0)
            out = segment_reduce(
                xs[own_slot[0]] * own_w[0][:, None],
                own_dst[0], n_loc, "sum",
            )
            out = out + segment_reduce(
                halo.reshape(D * H, -1)[halo_slot[0]]
                * halo_w[0][:, None],
                halo_dst[0], n_loc, "sum",
            )
            return out[None]

        run_jit = jax.jit(run)
        consts = tuple(
            jax.device_put(jnp.asarray(a), put)
            for a in (plan.send_idx, plan.own_slot, plan.own_dst,
                      plan.own_w, plan.halo_slot, plan.halo_dst,
                      plan.halo_w)
        )

        def call(shards, x):
            return run_jit(*consts, x)

        return call

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=spec,
    )
    def run(send_idx, src_slot, x_loc, csc_w, edst, emask):
        xs = x_loc[0]  # [n_loc, F]
        # rows this shard sends to every other shard: [D, H, F].  The
        # [s, s] diagonal slab (zero rows, send_mask False) stays in the
        # buffer: all_to_all's self-block is lowered to a LOCAL copy by
        # XLA, never wire traffic, and keeping it makes the t-major slot
        # arithmetic (slot = t*H + rank) uniform.  Wire traffic is
        # (D-1)*H rows per device.
        out_rows = xs[send_idx[0].reshape(-1)].reshape(D, H, -1)
        halo = exchange_slabs(out_rows, axis)  # [D, H, F] sender-major
        buf = jnp.concatenate(
            [halo.reshape(D * H, -1), xs], axis=0
        )  # [D*H + n_loc, F]
        msgs = buf[src_slot[0]] * csc_w[0][:, None]
        out = segment_reduce(
            msgs, edst[0], n_loc, "sum", mask=emask[0][:, None]
        )
        return out[None]

    run_jit = jax.jit(run)
    consts = (
        jax.device_put(jnp.asarray(plan.send_idx), put),
        jax.device_put(jnp.asarray(plan.src_slot), put),
    )

    def call(shards, x):
        return run_jit(
            consts[0], consts[1], x,
            shards.csc_weights, shards.csc_dsts_local, shards.edge_mask,
        )

    return call


def halo_spmm(
    pg: PartitionedGraph,
    shards: DeviceShards,
    plan: HaloPlan,
    x: jnp.ndarray,  # [D, n_loc, F] sharded on axis 0
    mesh: Mesh,
    axis="graph",
    overlap: bool = False,
) -> jnp.ndarray:
    """Pull-SpMM with boundary-only all-to-all exchange.

    ``axis`` may be one mesh axis name or a ("dcn", "ici") pair for the
    hierarchical 2-level exchange.  ``overlap=True`` uses the split-edge
    layout: the own-edge aggregation has no data dependency on the
    collective, so XLA overlaps it with the exchange."""
    return make_halo_spmm(pg, plan, mesh, axis, overlap)(shards, x)
