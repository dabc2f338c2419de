"""Distributed path at scale-19/20 dimensions on a device mesh.

This harness DEMONSTRATES — not asserts — that the partitioned halo path
runs at these sizes:

* executes the boundary-exchange (halo) SpMM and a 2-layer GCN forward
  at scale-19 and scale-20 dimensions on the 8-device CPU mesh (the
  same shard_map program that runs on a GPU mesh);
* validates the s19 halo aggregation against the single-device SpMM;
* accounts per-device memory at F=128 against one 80 GB card;
* records the wire-traffic table (halo vs all-gather rows per device).

CPU wall-times are recorded for completeness but are NOT perf claims
(8 virtual devices share the host's cores).

    JAX_PLATFORMS=cpu python bench_dist_scale.py [scales...]
"""

from __future__ import annotations

import json
import os
import sys
import time


def main():
    import jax

    from mini_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if os.environ.get("MINI_TPU_SCALING_BACKEND", "cpu") == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mini_tpu.graph import rmat
    from mini_tpu.parallel import (
        partition_graph, shard_to_mesh, build_halo_plan, make_halo_spmm,
    )

    scales = [int(a) for a in sys.argv[1:]] or [19, 20]
    D, F = 8, 128
    HBM_BUDGET = 80 * 10**9  # one H100
    results = {"devices": D, "F": F, "backend": jax.default_backend(),
               "hbm_budget_bytes": HBM_BUDGET, "rows": []}

    for scale in scales:
        t0 = time.perf_counter()
        hg = rmat(scale, edge_factor=16, seed=0, undirected=True)
        pg = partition_graph(hg, D)
        plan = build_halo_plan(pg)
        mesh = Mesh(np.array(jax.devices()[:D]), ("graph",))
        shards = shard_to_mesh(pg, mesh)
        build_s = time.perf_counter() - t0
        H = plan.halo_width

        # per-device memory at F=128; message stream = the aggregation's
        # msgs buffer, the largest transient if it is materialized
        def account(itemsize):
            topo = pg.m_loc * (4 + 4 + 4 + 1) + (pg.n_loc + 1) * 4
            x_slab = pg.n_loc * F * itemsize
            halo_bufs = 2 * D * H * F * itemsize  # send rows + recv slabs
            msgs = pg.m_loc * F * itemsize
            out = pg.n_loc * F * 4
            total = topo + x_slab + halo_bufs + msgs + out
            return {
                "topology": topo, "x_slab": x_slab,
                "halo_buffers": halo_bufs, "message_stream": msgs,
                "output": out, "total": total,
                "fits_budget": total < HBM_BUDGET,
            }

        mem = {"f32": account(4), "bf16": account(2)}
        single_chip_msgs_f32 = hg.m * F * 4

        rng = np.random.RandomState(0)
        x = jax.device_put(
            jnp.asarray(
                rng.rand(D, pg.n_loc, F).astype(np.float32)
            ),
            NamedSharding(mesh, P("graph")),
        )

        spmm_call = make_halo_spmm(pg, plan, mesh, overlap=True)
        t0 = time.perf_counter()
        agg = spmm_call(shards, x)
        agg.block_until_ready()
        spmm_first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        spmm_call(shards, x).block_until_ready()
        spmm_s = time.perf_counter() - t0

        # 2-layer GCN forward on the halo aggregation (shard-local
        # matmuls; the same program shape as parallel/gcn.py's forward)
        k = jax.random.PRNGKey(0)
        w1 = jax.random.normal(k, (F, F), jnp.float32) * 0.05
        w2 = jax.random.normal(k, (F, 32), jnp.float32) * 0.05

        def gcn_fwd(xx):
            h = jax.nn.relu(
                jnp.einsum("dnf,fg->dng", spmm_call(shards, xx), w1)
            )
            return jnp.einsum("dnf,fg->dng", spmm_call(shards, h), w2)

        t0 = time.perf_counter()
        out = gcn_fwd(x)
        out.block_until_ready()
        gcn_first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gcn_fwd(x).block_until_ready()
        gcn_s = time.perf_counter() - t0

        row = {
            "scale": scale,
            "n": hg.n, "m": hg.m,
            "n_loc": pg.n_loc, "m_loc": pg.m_loc,
            "halo_width": H,
            "build_s": build_s,
            "wire": {
                "allgather_rows_per_dev": (D - 1) * pg.n_loc,
                "halo_rows_per_dev": (D - 1) * H,
                "boundary_rows_real": int(plan.boundary_rows),
            },
            "mem_per_device": mem,
            "single_chip_f32_message_stream_bytes": single_chip_msgs_f32,
            "single_chip_f32_fits": single_chip_msgs_f32 < HBM_BUDGET,
            "halo_spmm_F128": {
                "completed": True,
                "first_call_s": spmm_first_s,
                "steady_cpu_wall_s_NOT_A_PERF_CLAIM": spmm_s,
            },
            "gcn_2layer_F128": {
                "completed": True,
                "first_call_s": gcn_first_s,
                "steady_cpu_wall_s_NOT_A_PERF_CLAIM": gcn_s,
            },
        }

        # one distributed GCN TRAINING step (psum'd grads, halo
        # exchange) at the same scale — the training path also clears
        # the wall, not just the forward
        if scale <= 19:
            from mini_tpu.models.gcn import gcn_init
            from mini_tpu.parallel.gcn import dist_gcn_train

            labels = jax.device_put(
                jnp.asarray(
                    rng.randint(0, 16, (D, pg.n_loc)).astype(np.int32)
                ),
                NamedSharding(mesh, P("graph")),
            )
            mask_t = jax.device_put(
                jnp.asarray(
                    (np.arange(pg.n_pad) < hg.n).reshape(D, pg.n_loc)
                ),
                NamedSharding(mesh, P("graph")),
            )
            t0 = time.perf_counter()
            _, losses = dist_gcn_train(
                pg, shards, mesh,
                gcn_init(jax.random.PRNGKey(1), [F, F, 16]),
                x, labels, mask_t, steps=1, halo_plan=plan,
                overlap=True,
            )
            row["gcn_train_step_F128"] = {
                "completed": bool(np.isfinite(losses[0])),
                "loss": float(losses[0]),
                "first_step_cpu_wall_s": time.perf_counter() - t0,
            }

        # correctness vs the single-device SpMM (narrow F keeps the
        # whole-graph reference within host RAM at these scales)
        if scale <= 19:
            from mini_tpu.graph import GraphSlice
            from mini_tpu.ops.spmm import spmm as spmm_single

            Fv = 16
            xv = jnp.asarray(
                rng.rand(D, pg.n_loc, Fv).astype(np.float32)
            )
            xv_dev = jax.device_put(xv, NamedSharding(mesh, P("graph")))
            got = np.asarray(
                make_halo_spmm(pg, plan, mesh, overlap=True)(
                    shards, xv_dev
                )
            ).reshape(D * pg.n_loc, Fv)
            gs_full = GraphSlice.from_host(hg)
            xf = np.zeros((gs_full.n_pad, Fv), np.float32)
            xf[: D * pg.n_loc] = np.asarray(xv).reshape(-1, Fv)
            exp = np.asarray(
                jax.jit(
                    lambda a: spmm_single(gs_full, a)
                )(jnp.asarray(xf))
            )
            ok = np.allclose(
                got[: hg.n], exp[: hg.n], rtol=1e-4, atol=1e-4
            )
            row["halo_vs_single_device_allclose_F16"] = bool(ok)

        results["rows"].append(row)
        print(
            f"s{scale}: m={hg.m} m_loc={pg.m_loc} H={H} "
            f"mem_f32={mem['f32']['total']/1e9:.2f}GB "
            f"mem_bf16={mem['bf16']['total']/1e9:.2f}GB "
            f"(single-chip f32 msgs "
            f"{single_chip_msgs_f32/1e9:.1f}GB) "
            f"spmm_ok gcn_ok "
            f"correct={row.get('halo_vs_single_device_allclose_F16')}",
            file=sys.stderr, flush=True,
        )
        with open("BENCH_DIST_SCALE.json", "w") as f:
            json.dump(results, f, indent=2)

    print(json.dumps({
        "metric": "dist_scale_demo",
        "scales": scales,
        "all_completed": all(
            r["gcn_2layer_F128"]["completed"] for r in results["rows"]
        ),
        "mem_bf16_fits": all(
            r["mem_per_device"]["bf16"]["fits_budget"]
            for r in results["rows"]
        ),
    }))


if __name__ == "__main__":
    main()
