"""Tracing / profiling hooks (SURVEY.md §5: the reference has none beyond a
wall clock; here they are `jax.profiler` traces and named scopes).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(dir_path: str = "/tmp/mini_tpu_trace"):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(dir_path)
    try:
        yield dir_path
    finally:
        jax.profiler.stop_trace()


def scope(name: str):
    """Named scope context so operators show up in profiles:

        with scope("advance"):
            ...
    """
    import jax

    return jax.named_scope(name)


def annotate(name: str):
    """Decorator form of :func:`scope`."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with scope(name):
                return fn(*a, **k)

        return wrapped

    return deco
