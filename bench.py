"""Benchmark driver: prints ONE JSON line with the headline metric
(BFS MTEPS on an RMAT graph) and writes the full suite to
BENCH_DETAILS.json.

    python bench.py [scale] [--trace]

Every section runs on the default JAX device, and a failing section fails
the run.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_argv = [a for a in sys.argv[1:] if a != "--trace"]
TRACE = "--trace" in sys.argv[1:]
SCALE = int(_argv[0]) if _argv else 16
EDGE_FACTOR = 16


def main():
    from mini_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mini_tpu.graph import rmat, GraphSlice
    from mini_tpu.algorithms import bfs, bfs_batch, sssp, sssp_batch, pagerank
    from mini_tpu.models.gcn import (
        gcn_normalize, gcn_init, gcn_forward, gcn_init_opt, gcn_train_step,
    )
    from mini_tpu.models.gat import (
        gat_init, gat_forward, gat_init_opt, gat_train_step,
    )
    from mini_tpu.ops.spmm import spmm
    from mini_tpu.utils.timing import time_fn

    dev = jax.devices()[0]
    results = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "scale": SCALE,
    }

    hg = rmat(SCALE, edge_factor=EDGE_FACTOR, seed=0, undirected=True,
              weighted=True)
    gs = GraphSlice.from_host(hg)
    results["n"], results["m"] = hg.n, hg.m
    print(f"# graph n={hg.n} m={hg.m}", file=sys.stderr, flush=True)

    def first_call(fn):
        """Run the first (compiling) call to completion; (result, secs)."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    compile_s = results["compile_s"] = {}

    def flush():
        with open("BENCH_DETAILS.json", "w") as f:
            json.dump(results, f, indent=2)

    # ---------------- BFS (headline) ----------------
    # RMAT leaves many vertices isolated; traverse from the max-degree hub
    src = int(np.argmax(hg.out_degrees))
    res, compile_s["bfs"] = first_call(lambda: bfs(gs, src))
    reached = np.asarray(res.labels)[: hg.n] >= 0
    # standard MTEPS accounting: edges in the reached component
    edges_reached = float(hg.out_degrees[reached].sum())
    t = time_fn(lambda: bfs(gs, src), warmup=1, repeat=3)
    bfs_mteps = edges_reached / t.min_s / 1e6
    results["bfs"] = {
        "iterations": int(res.num_iterations),
        "time_ms": t.min_s * 1e3,
        "mteps": bfs_mteps,
    }

    F = 128
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(gs.n_pad, F).astype(np.float32))
    if TRACE:
        # one profiler trace of a BFS run + an SpMM; the named scopes
        # (advance.*, engine.*) label the ops
        from mini_tpu.utils.profiling import trace as profiler_trace

        tdir = os.path.abspath("traces")
        with profiler_trace(tdir):
            jax.block_until_ready(bfs(gs, src).labels)
            jax.block_until_ready(spmm(gs, x))
        results["trace_dir"] = tdir

    # ---------------- SSSP ----------------
    res_s, compile_s["sssp"] = first_call(lambda: sssp(gs, src))
    t = time_fn(lambda: sssp(gs, src), warmup=1, repeat=2)
    results["sssp"] = {
        "iterations": int(res_s.num_iterations),
        "time_ms": t.min_s * 1e3,
        "mteps": edges_reached / t.min_s / 1e6,
    }

    # ---------------- PageRank ----------------
    res_p, compile_s["pagerank"] = first_call(
        lambda: pagerank(gs, max_iter=30)
    )
    iters = max(int(res_p.num_iterations), 1)
    t = time_fn(lambda: pagerank(gs, max_iter=30), warmup=1, repeat=2)
    results["pagerank"] = {
        "iterations": iters,
        "time_ms": t.min_s * 1e3,
        "edges_per_s": hg.m * iters / t.min_s,
    }
    flush()

    # ---------------- GCN / GAT forwards, f32 and bf16 messages --------
    norm = gcn_normalize(gs)
    params = gcn_init(jax.random.PRNGKey(0), [F, F, 32])
    gat_params = gat_init(jax.random.PRNGKey(1), [F, 32, 32], heads=2)
    dtypes = [("f32", None), ("bf16", jnp.bfloat16)]
    for name, mdt in dtypes:
        fwd = jax.jit(lambda p, g, nm, xx, mdt=mdt: gcn_forward(
            p, g, nm, xx, message_dtype=mdt))
        _, compile_s[f"gcn_{name}"] = first_call(
            lambda: fwd(params, gs, norm, x))
        t = time_fn(lambda: fwd(params, gs, norm, x), warmup=1, repeat=3)
        results[f"gcn_{name}"] = {
            "time_ms": t.min_s * 1e3,
            "agg_edges_per_s": 2 * hg.m / t.min_s,
        }
    for name, mdt in dtypes:
        fwd = jax.jit(lambda p, g, xx, mdt=mdt: gat_forward(
            p, g, xx, message_dtype=mdt))
        _, compile_s[f"gat_{name}"] = first_call(
            lambda: fwd(gat_params, gs, x))
        t = time_fn(lambda: fwd(gat_params, gs, x), warmup=1, repeat=3)
        results[f"gat_{name}"] = {
            "time_ms": t.min_s * 1e3,
            "agg_edges_per_s": 2 * hg.m / t.min_s,
        }

    # ---------------- SpMM (in-loop) ----------------
    # ITERS data-dependent calls inside ONE jitted fori_loop, per-op =
    # total / ITERS.
    ITERS = 10
    results["spmm_inloop"] = {"iters": ITERS, "F": F}
    for label, dtype in [("f32", jnp.float32), ("bf16", jnp.bfloat16)]:
        x0 = x.astype(dtype)

        def step(g, acc, dtype=dtype):
            return (spmm(g, acc) * jnp.asarray(2e-4, dtype)).astype(dtype)

        run = jax.jit(lambda g, x0, step=step: jax.lax.fori_loop(
            0, ITERS, lambda i, a: step(g, a), x0))
        t = time_fn(lambda: run(gs, x0), warmup=1, repeat=2)
        item = jnp.dtype(dtype).itemsize
        per_op_s = t.min_s / ITERS
        bytes_min = gs.m_pad * F * item + gs.n_pad * F * item
        results["spmm_inloop"][label] = {
            "per_op_ms": per_op_s * 1e3,
            "min_traffic_gbps": bytes_min / per_op_s / 1e9,
        }
    flush()
    print(
        json.dumps(
            {
                "metric": f"bfs_mteps_rmat{SCALE}",
                "value": round(bfs_mteps, 2),
                "unit": "MTEPS",
                "device_kind": dev.device_kind,
            }
        ),
        flush=True,
    )

    # ---------------- multi-source batches ----------------
    # Graph500-style: top-R-degree sources, one jitted scan.
    R = 8
    srcs_np = np.argsort(hg.out_degrees)[-R:].astype(np.int32)
    srcs_d = jnp.asarray(srcs_np)
    edges_r = 0.0
    for s_i in srcs_np:
        lab = np.asarray(bfs(gs, int(s_i)).labels)[: hg.n]
        edges_r += float(hg.out_degrees[lab >= 0].sum())
    _, compile_s["bfs_batch"] = first_call(lambda: bfs_batch(gs, srcs_d))
    t = time_fn(lambda: bfs_batch(gs, srcs_d), warmup=1, repeat=3)
    _, compile_s["bfs_batch_lab"] = first_call(
        lambda: bfs_batch(gs, srcs_d, with_preds=False))
    tl = time_fn(lambda: bfs_batch(gs, srcs_d, with_preds=False),
                 warmup=1, repeat=3)
    results["bfs_batch"] = {
        "sources": R,
        "per_bfs_ms": t.min_s / R * 1e3,
        "mteps_amortized": edges_r / t.min_s / 1e6,
        "per_bfs_ms_labels_only": tl.min_s / R * 1e3,
        "mteps_amortized_labels_only": edges_r / tl.min_s / 1e6,
    }
    _, compile_s["sssp_batch"] = first_call(lambda: sssp_batch(gs, srcs_d))
    t = time_fn(lambda: sssp_batch(gs, srcs_d), warmup=1, repeat=3)
    results["sssp_batch"] = {
        "sources": R,
        "per_sssp_ms": t.min_s / R * 1e3,
    }
    flush()

    # ---------------- training steps ----------------
    # One full optimizer step (fwd + bwd + SGD-momentum update); each row
    # also reports the ratio to its own forward.
    labels_t = jnp.asarray(np.random.RandomState(1).randint(0, 32, gs.n_pad))
    mask_t = jnp.arange(gs.n_pad) < hg.n
    for kind in ("gcn", "gat"):
        for name, mdt in dtypes:
            label = f"{kind}_train_{name}"
            if kind == "gcn":
                p0 = gcn_init(jax.random.PRNGKey(2), [F, F, 32])
                o0 = gcn_init_opt(p0)
                stepf = lambda p, o, mdt=mdt: gcn_train_step(  # noqa: E731
                    p, o, gs, norm, x, (labels_t, mask_t), 1e-2, mdt)
            else:
                p0 = gat_init(jax.random.PRNGKey(2), [F, 32, 32], heads=2)
                o0 = gat_init_opt(p0)
                stepf = lambda p, o, mdt=mdt: gat_train_step(  # noqa: E731
                    p, o, gs, x, (labels_t, mask_t), 1e-2, 0.2, mdt)
            (p1, o1, loss1), compile_s[label] = first_call(
                lambda: stepf(p0, o0))
            # donated buffers: thread fresh state through each timed call
            state = {"p": p1, "o": o1}

            def timed(state=state, stepf=stepf):
                p, o, loss = stepf(state["p"], state["o"])
                state["p"], state["o"] = p, o
                return loss

            t = time_fn(timed, warmup=1, repeat=3)
            fwd_ms = results[f"{kind}_{name}"]["time_ms"]
            results[label] = {
                "time_ms": t.min_s * 1e3,
                "loss": float(loss1),
                "vs_forward": t.min_s * 1e3 / fwd_ms,
            }
    flush()


if __name__ == "__main__":
    main()
