"""Frontiers: dense bitmap first, compact index form second.

The reference's ``frontier_t<T>`` (`/root/reference/gunrock/src/frontier.hxx:13-99`)
is a fixed-capacity device index vector with logical resize (hard exit on
overflow) plus sparse<->dense converters bolted onto advance
(`advance.hxx:70-106`).  Here the dense bitmap is the *primary*
representation — fixed shape, jit-friendly, and duplicate-free by
construction (which subsumes the reference's heuristic warp/history-hash
uniquify culls, `filter.hxx:33-119`).  The compact form is a bounded index
array + on-device count, used for host interop and (later) sparse-gather
advance paths.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frontier:
    """Dense vertex (or edge) frontier over a padded id space."""

    mask: jnp.ndarray  # bool[n_pad]

    @staticmethod
    def empty(n_pad: int) -> "Frontier":
        return Frontier(jnp.zeros(n_pad, dtype=jnp.bool_))

    @staticmethod
    def full(n_pad: int, n: int) -> "Frontier":
        return Frontier(jnp.arange(n_pad) < n)

    @staticmethod
    def from_indices(indices, n_pad: int) -> "Frontier":
        indices = jnp.asarray(indices)
        mask = jnp.zeros(n_pad, dtype=jnp.bool_)
        valid = (indices >= 0) & (indices < n_pad)
        return Frontier(
            mask.at[jnp.where(valid, indices, n_pad - 1)].max(valid)
        )

    def size(self) -> jnp.ndarray:
        """On-device element count (no host sync)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def to_indices(
        self, capacity: int
    ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Compact to a bounded index list.

        Returns (indices int32[capacity], count, overflowed).  Slots past
        ``count`` are filled with -1 (the reference uses -1 holes too,
        `advance.hxx:60`); ``overflowed`` is True when the true population
        exceeded ``capacity`` (the reference hard-exits on frontier
        overflow, `frontier.hxx:85-93` — here the flag is on-device and
        the caller decides).  Masked compaction in the role of
        moderngpu's ``transform_compact`` upsweep/downsweep
        (`filter.hxx:18-30`), by ``lax.top_k`` (see ``compact_mask``).
        """
        return compact_mask(self.mask, capacity)

    def __and__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask & other.mask)

    def __or__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask | other.mask)


def compact_mask(
    mask: jnp.ndarray, capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Indices of set bits, bounded by ``capacity``; -1 padded.

    Returns (indices, count, overflowed): ``overflowed`` is a bool scalar
    set when the population exceeds ``capacity`` — entries past capacity
    are dropped, and the flag makes that detectable (the reference's
    frontier exits the process instead, `frontier.hxx:85-93`).
    """
    # top_k over position-coded values: the k largest ARE the k smallest
    # set positions (in place of a cumsum + n-sized scatter)
    import jax

    n = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    vals = jnp.where(
        mask, jnp.int32(n) - jnp.arange(n, dtype=jnp.int32), jnp.int32(0)
    )
    top, _ = jax.lax.top_k(vals, capacity)
    idx = jnp.where(top > 0, jnp.int32(n) - top, -1)
    return idx, jnp.minimum(count, capacity), count > capacity


def uniquify(indices: jnp.ndarray, n_pad: int, capacity: int | None = None):
    """Exact dedup of an index frontier via bitmap round-trip.

    Replaces the reference's three heuristic culls (bitmask/warp-hash/
    history-hash, `filter.hxx:33-119`) with exact, deterministic dedup —
    those culls bound shared-memory work; the bitmap makes dedup exact.
    Negative indices (holes) are dropped.  Returns (indices, count,
    overflowed) — see ``compact_mask``.
    """
    capacity = capacity or indices.shape[0]
    f = Frontier.from_indices(indices, n_pad)
    return f.to_indices(capacity)
