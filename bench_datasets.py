"""Per-dataset benchmark: BFS / SSSP / PageRank / GCN across graph
families, generated deterministically (nothing is downloaded, so
SuiteSparse/OGB files are not fetched; each family's stand-in matches its
structural profile):

* rmat16            — soc-LiveJournal-class power-law (BFS config)
* delaunay_n17      — the delaunay_nXX family itself (SSSP config;
                      planar, uniform degree ~6)
* grid2d 512x512    — road-network profile (huge diameter, degree <= 4)
* arxiv-like s15    — ogbn-arxiv-style node classification (GCN config;
                      RMAT topology + homophilous rewiring)

    python bench_datasets.py          -> BENCH_DATASETS.json
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main():
    from mini_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mini_tpu.graph import (
        rmat, delaunay, grid2d, GraphSlice,
    )
    from mini_tpu.graph.datasets import synthetic_arxiv_like
    from mini_tpu.algorithms import bfs, sssp, pagerank
    from mini_tpu.models.gcn import gcn_normalize, gcn_init, gcn_forward
    from mini_tpu.utils.timing import time_fn

    results = {"device": str(jax.devices()[0]), "datasets": {}}

    def log(m):
        print(f"# {m}", file=sys.stderr, flush=True)

    arxiv = synthetic_arxiv_like(scale=15)
    datasets = [
        ("rmat16", rmat(16, edge_factor=16, seed=0, undirected=True,
                        weighted=True)),
        ("delaunay_n17", delaunay(17, seed=0, weighted=True)),
        ("grid2d_512", grid2d(512, 512, seed=0, weighted=True)),
        ("arxiv_like_s15", arxiv.graph),
    ]

    for name, hg in datasets:
        gs = GraphSlice.from_host(hg)
        row = {"n": hg.n, "m": hg.m}
        src = int(np.argmax(hg.out_degrees))
        log(f"{name}: n={hg.n} m={hg.m}")

        def bench(key, fn, repeat=2):
            try:
                t = time_fn(fn, warmup=1, repeat=repeat)
                row[key] = round(t.min_s * 1e3, 2)
                log(f"  {key}: {row[key]} ms")
            except Exception as exc:
                row[key] = f"error: {repr(exc)[:120]}"
                log(f"  {key}: FAILED")
            results["datasets"][name] = row
            with open("BENCH_DATASETS.json", "w") as f:
                json.dump(results, f, indent=2)

        res = bfs(gs, src)
        reached = np.asarray(res.labels)[: hg.n] >= 0
        edges_reached = float(hg.out_degrees[reached].sum())
        row["bfs_iterations"] = int(res.num_iterations)
        bench("bfs_ms", lambda: bfs(gs, src))
        if isinstance(row.get("bfs_ms"), float):
            row["bfs_mteps"] = round(
                edges_reached / row["bfs_ms"] / 1e3, 1
            )
        bench("sssp_ms", lambda: sssp(gs, src))
        bench("pagerank_ms", lambda: pagerank(gs, max_iter=30))

        F = 128
        norm = gcn_normalize(gs)
        params = gcn_init(jax.random.PRNGKey(0), [F, F, 32])
        if name == "arxiv_like_s15":
            feats = arxiv.features
            x = jnp.asarray(
                np.pad(feats, ((0, gs.n_pad - hg.n), (0, 0)))
                .astype(np.float32)
            )
        else:
            x = jnp.asarray(
                np.random.RandomState(0).rand(gs.n_pad, F)
                .astype(np.float32)
            )
        fwd = jax.jit(lambda p, xx: gcn_forward(p, gs, norm, xx))
        bench("gcn_fwd_ms", lambda: fwd(params, x))

    print(json.dumps({"metric": "bench_datasets",
                      "datasets": len(results["datasets"])}))


if __name__ == "__main__":
    main()
