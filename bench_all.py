"""Extended benchmark suite: every primitive + model forward, one JSON
object per line to stderr-progress / BENCH_ALL.json.  (bench.py stays the
driver headline; this one covers the full surface and takes longer.)

    python bench_all.py [scale]
"""

from __future__ import annotations

import json
import sys

import numpy as np

SCALE = int(sys.argv[1]) if len(sys.argv) > 1 else 14


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)



def main():
    from mini_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mini_tpu.graph import rmat, GraphSlice
    from mini_tpu.algorithms import (
        bfs,
        sssp,
        pagerank,
        coloring,
        kcore,
        lspar,
    )
    from mini_tpu.models.gcn import gcn_normalize, gcn_init, gcn_forward
    from mini_tpu.models.sage import sage_init, sage_forward
    from mini_tpu.models.gat import gat_init, gat_forward
    from mini_tpu.utils.timing import time_fn

    results = {"device": str(jax.devices()[0]), "scale": SCALE}
    hg = rmat(SCALE, edge_factor=16, seed=0, undirected=True, weighted=True)
    gs = GraphSlice.from_host(hg)
    results["n"], results["m"] = hg.n, hg.m
    src = int(np.argmax(hg.out_degrees))
    log(f"graph n={hg.n} m={hg.m}")

    def bench(name, fn, repeat=3):
        try:
            t = time_fn(fn, warmup=1, repeat=repeat)
            results[name] = {"time_ms": t.min_s * 1e3}
            log(f"{name}: {t.min_s * 1e3:.2f} ms")
        except Exception as exc:
            results[name] = {"error": repr(exc)[:200]}
            log(f"{name}: FAILED {exc!r}")
        with open("BENCH_ALL.json", "w") as f:  # incremental: survive timeouts
            json.dump(results, f, indent=2)

    bench("bfs", lambda: bfs(gs, src))
    bench("sssp", lambda: sssp(gs, src))
    bench("pagerank", lambda: pagerank(gs, max_iter=30), repeat=2)
    bench("coloring", lambda: coloring(gs, max_iter=64), repeat=2)
    bench("kcore", lambda: kcore(gs), repeat=2)
    bench("lspar", lambda: lspar(gs), repeat=2)

    F = 128
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(gs.n_pad, F).astype(np.float32))
    norm = gcn_normalize(gs)
    gcn_p = gcn_init(jax.random.PRNGKey(0), [F, F, 32])
    fwd_gcn = jax.jit(lambda p, xx: gcn_forward(p, gs, norm, xx))
    bench("gcn_fwd", lambda: fwd_gcn(gcn_p, x))
    sage_p = sage_init(jax.random.PRNGKey(1), [F, F, 32])
    fwd_sage = jax.jit(lambda p, xx: sage_forward(p, gs, xx))
    bench("sage_fwd", lambda: fwd_sage(sage_p, x))
    gat_p = gat_init(jax.random.PRNGKey(2), [F, 64, 32], heads=2)
    fwd_gat = jax.jit(lambda p, xx: gat_forward(p, gs, xx))
    bench("gat_fwd", lambda: fwd_gat(gat_p, x))
    fwd_gat16 = jax.jit(
        lambda p, xx: gat_forward(p, gs, xx, message_dtype=jnp.bfloat16)
    )
    bench("gat_fwd_bf16", lambda: fwd_gat16(gat_p, x))

    with open("BENCH_ALL.json", "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"metric": f"bench_all_rmat{SCALE}", "ok": True}))


if __name__ == "__main__":
    main()
