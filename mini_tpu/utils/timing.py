"""Benchmark timing utilities (the reference's ad-hoc ``test_timer_t``,
`/root/reference/gunrock/tests/test_utils.hxx:168-191`, upgraded with warmup,
repetition statistics, and MTEPS reporting — which the reference lacks)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Timing:
    mean_s: float
    min_s: float
    std_s: float
    runs: int

    def mteps(self, edges_traversed: float) -> float:
        """Millions of traversed edges per second (graph-framework standard
        metric; min time = peak rate)."""
        return edges_traversed / self.min_s / 1e6


def time_fn(
    fn: Callable[[], object],
    warmup: int = 2,
    repeat: int = 5,
    block: Callable[[object], None] | None = None,
) -> Timing:
    """Time ``fn`` with device-sync via ``block`` (jax.block_until_ready)."""
    if block is None:
        import jax

        block = jax.block_until_ready
    for _ in range(warmup):
        block(fn())
    samples = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        block(fn())
        samples.append(time.perf_counter() - t0)
    a = np.array(samples)
    return Timing(
        mean_s=float(a.mean()),
        min_s=float(a.min()),
        std_s=float(a.std()),
        runs=repeat,
    )


class wall_timer:
    """Context-manager wall clock."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
