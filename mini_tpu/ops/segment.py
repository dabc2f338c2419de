"""Deterministic segmented reductions in place of atomics.

The reference resolves concurrent per-destination updates with
atomicCAS/atomicMin/atomicAdd (`/root/reference/gunrock/src/intrinsics.hxx:12-22`,
`bfs/bfs_functor.hxx:32`, `kcore/kcore_functor.hxx:34`) and folds neighbor
values with moderngpu's ``lbs_segreduce`` (`neighborhood.hxx:58`).  Here
both roles collapse into one primitive: a segmented reduction over an edge
array whose segment ids are *sorted* (CSR order sorts by src, CSC order by
dst).  Sorted segment ids make the result independent of thread scheduling
for integer and min/max reductions, and let XLA lower it efficiently.

Everything here is shape-static and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def identity_for(op: str, dtype) -> jnp.ndarray:
    if op == "sum":
        return jnp.zeros((), dtype)
    if op == "min":
        if jnp.issubdtype(dtype, jnp.floating):
            return jnp.array(jnp.inf, dtype)
        return jnp.array(jnp.iinfo(dtype).max, dtype)
    if op == "max":
        if jnp.issubdtype(dtype, jnp.floating):
            return jnp.array(-jnp.inf, dtype)
        return jnp.array(jnp.iinfo(dtype).min, dtype)
    if op == "or":
        return jnp.array(False)
    if op == "and":
        return jnp.array(True)
    raise ValueError(f"unknown op {op!r}")


def contiguous_segment_sum(
    vals: jnp.ndarray,
    offsets: jnp.ndarray,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Segment sum for CONTIGUOUS segments given boundary offsets:
    ``out[v] = sum(vals[offsets[v]:offsets[v+1]])``.

    One cumsum + two gathers — no scatter at all (the reference needs
    moderngpu's two-phase compact/segreduce for this; CSC/CSR ordering makes
    it a prefix-sum difference).  Exact for integer/bool inputs; for
    floats the cumsum accumulates over the whole array, so only use where
    that precision is acceptable.
    """
    if mask is not None:
        vals = jnp.where(mask, vals, jnp.zeros((), vals.dtype))
    c = jnp.concatenate(
        [jnp.zeros((1,) + vals.shape[1:], vals.dtype), jnp.cumsum(vals, 0)]
    )
    off = offsets.astype(jnp.int32)
    return c[off[1:]] - c[off[:-1]]


def segment_reduce(
    vals: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    op: str = "sum",
    mask: jnp.ndarray | None = None,
    indices_are_sorted: bool = True,
    offsets: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reduce ``vals`` into ``num_segments`` buckets keyed by ``seg_ids``.

    ``mask`` elements set to False contribute the identity.  Boolean ``or`` /
    ``and`` are computed in int space then cast back (XLA scatter combiners
    are arithmetic).  When ``offsets`` (contiguous segment boundaries,
    int[num_segments+1]) are provided, integer/bool sums and or/and reduce
    via the scatter-free cumsum-difference path.
    """
    if offsets is not None and vals.dtype != jnp.float32:
        if op == "sum" and jnp.issubdtype(vals.dtype, jnp.integer):
            return contiguous_segment_sum(vals, offsets, mask=mask)
        if op == "or":
            s = contiguous_segment_sum(
                vals.astype(jnp.int32), offsets, mask=mask
            )
            return s > 0
        if op == "and":
            inv = ~vals if mask is None else (~vals & mask)
            s = contiguous_segment_sum(inv.astype(jnp.int32), offsets)
            return s == 0
    if op in ("or", "and"):
        # int space: or -> max, and -> min; empty segments yield the integer
        # identity (INT_MIN / INT_MAX), so compare > 0 rather than casting
        # (empty "or" must be False, empty "and" True).
        ivals = vals.astype(jnp.int32)
        red = segment_reduce(
            ivals,
            seg_ids,
            num_segments,
            "max" if op == "or" else "min",
            mask=mask,
            indices_are_sorted=indices_are_sorted,
        )
        return red > 0

    if mask is not None:
        vals = jnp.where(mask, vals, identity_for(op, vals.dtype))

    kw = dict(
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
        unique_indices=False,
    )
    if op == "sum":
        return jax.ops.segment_sum(vals, seg_ids, **kw)
    if op == "min":
        return jax.ops.segment_min(vals, seg_ids, **kw)
    if op == "max":
        return jax.ops.segment_max(vals, seg_ids, **kw)
    raise ValueError(f"unknown op {op!r}")


def segment_argmin_by(
    keys: jnp.ndarray,
    payload: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-segment (min key, min payload among key-minimizers).

    Deterministic tiebreak: among elements achieving the per-segment minimum
    key, the smallest payload wins.  This replaces the reference's benign-race
    predecessor writes (`sssp/sssp_functor.hxx:30-33`) with a reproducible
    choice.
    """
    min_keys = segment_reduce(keys, seg_ids, num_segments, "min", mask=mask)
    at_min = keys == min_keys[seg_ids]
    if mask is not None:
        at_min = at_min & mask
    min_payload = segment_reduce(
        payload, seg_ids, num_segments, "min", mask=at_min
    )
    return min_keys, min_payload


@jax.jit
def exclusive_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum along axis 0 (the reference's ``transform_scan``,
    `advance.hxx:40`), kept on device — no host readback of the total."""
    c = jnp.cumsum(x, axis=0)
    return jnp.concatenate([jnp.zeros((1,) + x.shape[1:], x.dtype), c[:-1]], 0)
