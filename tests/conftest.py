"""Test harness config.

Tests run on the CPU backend with 8 virtual devices so multi-device sharding
paths (`mini_tpu.parallel`) are exercised without accelerators.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from mini_tpu.graph import from_edges, erdos_renyi, GraphSlice


@pytest.fixture(scope="session")
def tiny_graph():
    """The reference BFS fixture graph (7 nodes, 15 undirected-doubled edges),
    re-declared from /root/reference/gunrock/tests/bfs/test.mtx (1-based
    there; 0-based here, with column 1 as source)."""
    edges = [
        (1, 0), (2, 0), (3, 0), (0, 1), (4, 1), (2, 1), (3, 2), (4, 2),
        (5, 2), (5, 3), (6, 3), (2, 4), (5, 4), (6, 4), (6, 5),
    ]
    srcs, dsts = zip(*edges)
    return from_edges(
        np.array(srcs), np.array(dsts), num_nodes=7, make_undirected=True
    )


@pytest.fixture(scope="session")
def random_graph():
    return erdos_renyi(200, 1200, seed=3, undirected=True, weighted=True)


@pytest.fixture(scope="session")
def random_directed_graph():
    return erdos_renyi(150, 900, seed=7, undirected=False, weighted=True)


@pytest.fixture(scope="session")
def tiny_slice(tiny_graph):
    return GraphSlice.from_host(tiny_graph)


@pytest.fixture(scope="session")
def random_slice(random_graph):
    return GraphSlice.from_host(random_graph)


@pytest.fixture(scope="session")
def random_directed_slice(random_directed_graph):
    return GraphSlice.from_host(random_directed_graph)
