"""mini-tpu: a data-centric graph processing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of gunrock/mini:
frontier-centric graph algorithms expressed as a small set of operators
(advance, filter, neighborhood-reduce) over shared CSR/CSC graph storage,
formulated for a compiled array program:

* frontiers are dense bitmaps (fixed shapes, jit-friendly) with an optional
  compact (index) form,
* advance/neighborhood are edge-centric vectorized sweeps with deterministic
  segment reductions (no atomics; cf. reference `intrinsics.hxx:12-22`),
* iteration loops run fully on device under `lax.while_loop` (the reference
  syncs device->host every iteration, `advance.hxx:43`),
* feature-valued aggregation (SpMM: gather + segment reduce) powers GNN
  message passing over the same graph slice,
* multi-device scaling is edge partitioning + `shard_map` collectives over a
  `jax.sharding.Mesh` (the reference is single-GPU only, `README.md:4`).
"""

__version__ = "0.1.0"

from mini_tpu.graph import (  # noqa: F401
    HostGraph,
    GraphSlice,
    load_mtx,
    save_mtx,
    from_edges,
    erdos_renyi,
    rmat,
)
from mini_tpu.ops import (  # noqa: F401
    Frontier,
    segment_reduce,
    reduce_by_dst,
    reduce_by_src,
    advance,
    filter_frontier,
    neighborhood_reduce,
    compute,
    uniquify,
    spmm,
    sddmm,
)
