"""Segmented sort — the reusable form of moderngpu's ``segmented_sort``
(`/root/reference/gunrock/src/lspar/lspar_enactor.hxx:85`).

A per-segment sort is ONE global stable sort keyed by
(segment id, key): segments are contiguous, so composite-key ordering sorts
within each segment without ever materializing per-segment work lists.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sort(
    keys: jnp.ndarray,  # [m]
    seg_ids: jnp.ndarray,  # int32[m] sorted (CSR srcs / CSC dsts)
    *payloads: jnp.ndarray,
    descending: bool = False,
):
    """Sort keys (and payloads) within each contiguous segment.

    Returns (sorted_keys, *sorted_payloads).  Stable.  For descending float
    keys the sign-flip trick keeps a single ascending sort.
    """
    k = keys
    if descending:
        if jnp.issubdtype(k.dtype, jnp.floating):
            k = -k
        else:
            k = jnp.bitwise_not(k)
    out = jax.lax.sort(
        (seg_ids, k, jnp.arange(keys.shape[0], dtype=jnp.int32))
        + tuple(payloads),
        num_keys=2,
        is_stable=True,
    )
    sorted_k = out[1]
    if descending:
        sorted_k = (
            -sorted_k
            if jnp.issubdtype(keys.dtype, jnp.floating)
            else jnp.bitwise_not(sorted_k)
        )
    return (sorted_k,) + tuple(out[3:]) if payloads else sorted_k


def segment_argsort(
    keys: jnp.ndarray,
    seg_ids: jnp.ndarray,
    descending: bool = False,
) -> jnp.ndarray:
    """Positions (into the original array) of the within-segment sort."""
    k = keys
    if descending:
        if jnp.issubdtype(k.dtype, jnp.floating):
            k = -k
        else:
            k = jnp.bitwise_not(k)
    out = jax.lax.sort(
        (seg_ids, k, jnp.arange(keys.shape[0], dtype=jnp.int32)),
        num_keys=2,
        is_stable=True,
    )
    return out[2]
