"""Command-line drivers — parity with the reference test binaries
(`/root/reference/gunrock/tests/*/test_*.cu`): load graph -> run primitive ->
time -> extract -> CPU-validate -> report.

Usage:
    python -m mini_tpu.cli bfs --file tests/fixtures/test_bfs.mtx --src 0
    python -m mini_tpu.cli sssp --file g.mtx --src 0 --random-weights
    python -m mini_tpu.cli pr --file g.mtx --max-iter 50
    python -m mini_tpu.cli coloring|kcore|lspar --file g.mtx
    python -m mini_tpu.cli bfs --rmat-scale 16 --src 0       # generated input

Flags mirror the reference CLI (`tests/test_utils.hxx:17-155` + per-driver
flags: --src, --alpha, --undirected, --max-iter, --prime, --e, --seed).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(args):
    from mini_tpu.graph import (
        load_mtx, rmat, delaunay, grid2d, GraphSlice,
    )

    if args.file:
        hg = load_mtx(
            args.file,
            undirected=args.undirected,
            random_weights=args.random_weights,
            seed=args.seed,
        )
    elif args.rmat_scale:
        hg = rmat(
            args.rmat_scale,
            edge_factor=args.edge_factor,
            seed=args.seed,
            weighted=args.random_weights,
        )
    elif args.delaunay_scale:
        hg = delaunay(
            args.delaunay_scale, seed=args.seed,
            weighted=args.random_weights,
        )
    elif args.grid:
        hg = grid2d(
            args.grid, args.grid, seed=args.seed,
            weighted=args.random_weights,
        )
    else:
        sys.exit("need --file, --rmat-scale, --delaunay-scale or --grid")
    return hg, GraphSlice.from_host(hg)


def main(argv=None):
    p = argparse.ArgumentParser(prog="mini_tpu")
    p.add_argument(
        "algo",
        choices=["bfs", "sssp", "pr", "coloring", "kcore", "lspar",
                 "cc", "gcn", "gat", "sage"],
    )
    p.add_argument("--file", default=None)
    p.add_argument("--rmat-scale", type=int, default=None)
    p.add_argument(
        "--delaunay-scale", type=int, default=None,
        help="Delaunay triangulation of 2**scale random points (the "
        "delaunay_nXX SuiteSparse family)",
    )
    p.add_argument(
        "--grid", type=int, default=None,
        help="N x N 4-neighbor lattice (road-network stress profile)",
    )
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--src", type=int, default=0)
    p.add_argument(
        "--sources", default=None,
        help="comma list of sources for batched BFS/SSSP (one jitted scan "
        "amortizes the per-dispatch cost across the batch)",
    )
    p.add_argument(
        "--heads", type=int, default=2,
        help="gat: attention heads per layer",
    )
    p.add_argument(
        "--sssp-variant", choices=["bellman", "delta", "auto"],
        default="bellman",
        help="sssp algorithm: frontier Bellman-Ford (default), "
        "delta-stepping (bucketed; wins on high-diameter weighted "
        "graphs), or auto (degree-based pick)",
    )
    p.add_argument(
        "--delta", type=float, default=None,
        help="delta-stepping bucket width (default: mean edge weight)",
    )
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--prime", type=int, default=999983)
    p.add_argument("--e", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--queue-sizing",
        type=float,
        default=None,
        help="sparse-frontier capacity as a fraction of m (the reference's "
        "frontier-capacity multiplier, tests/test_utils.hxx via "
        "--queue-sizing); default lets the tier builder pick ~m/64",
    )
    p.add_argument(
        "--kcore-variant",
        choices=["auto", "mini", "hindex"],
        default="auto",
        help="kcore algorithm: reference peel semantics (mini) or true "
        "coreness via the h-index fixpoint (hindex, undirected only)",
    )
    p.add_argument(
        "--hashes-per-round",
        type=int,
        default=16,
        help="coloring: independent hash orders per round (1 = exact "
        "reference recipe)",
    )
    p.add_argument("--validate", action="store_true")
    p.add_argument("--repeat", type=int, default=5)
    p.add_argument(
        "--cpu",
        action="store_true",
        help="force the CPU backend",
    )
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from mini_tpu.utils.timing import time_fn
    from mini_tpu.utils.validate import validate_exact, display_device_data

    hg, gs = _load(args)
    print(f"graph: n={hg.n} m={hg.m} (padded {gs.n_pad}/{gs.m_pad})")
    qs_cap = (
        None
        if args.queue_sizing is None
        else max(2048, int(gs.m_pad * args.queue_sizing))
    )

    srcs = (
        [int(s) for s in args.sources.split(",")]
        if args.sources
        else None
    )

    if args.algo == "bfs":
        from mini_tpu.algorithms import bfs, bfs_cpu
        from mini_tpu.algorithms.bfs import bfs_batch

        if srcs is not None:
            run = lambda: bfs_batch(gs, srcs, alpha=args.alpha,  # noqa: E731
                                    sparse_capv=qs_cap,
                                    sparse_cape=qs_cap)
        else:
            run = lambda: bfs(gs, args.src, alpha=args.alpha,  # noqa: E731
                              sparse_capv=qs_cap, sparse_cape=qs_cap)
        res = run()
        t = time_fn(run)
        labels = np.asarray(res.labels)
        labels2d = labels if labels.ndim == 2 else labels[None]
        edges = sum(
            hg.out_degrees[(lab >= 0)[: hg.n]].sum() for lab in labels2d
        )
        if bool(np.any(np.asarray(res.sparse_overflowed))):
            print("WARNING: sparse tier overflowed — result untrusted")
        print(
            f"iterations: {np.asarray(res.num_iterations).tolist()} "
            f"(pull: {np.asarray(res.num_pull_iterations).tolist()})"
        )
        per = f" ({t.min_s / labels2d.shape[0] * 1e3:.3f} ms/src)" \
            if labels.ndim == 2 else ""
        print(f"elapsed: {t.min_s * 1e3:.3f} ms{per}  "
              f"MTEPS: {t.mteps(edges):.1f}")
        display_device_data(labels2d[0], name="labels")
        if args.validate:
            ok = all(
                validate_exact(lab[: hg.n], bfs_cpu(hg, s))
                for lab, s in zip(
                    labels2d, srcs if srcs is not None else [args.src]
                )
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "sssp":
        from mini_tpu.algorithms import sssp, sssp_cpu
        from mini_tpu.algorithms.sssp import sssp_batch

        if srcs is not None:
            run = lambda: sssp_batch(gs, srcs, sparse_capv=qs_cap,  # noqa: E731
                                     sparse_cape=qs_cap,
                                     variant=args.sssp_variant,
                                     delta=args.delta)
        else:
            run = lambda: sssp(gs, args.src, sparse_capv=qs_cap,  # noqa: E731
                               sparse_cape=qs_cap,
                               variant=args.sssp_variant,
                               delta=args.delta)
        res = run()
        t = time_fn(run)
        dists = np.asarray(res.dists)
        dists2d = dists if dists.ndim == 2 else dists[None]
        # standard MTEPS accounting: edges in the reached component
        # (same convention as BFS; the reference prints raw wall clock only,
        # tests/sssp/test_sssp.cu:38-42)
        edges = sum(
            hg.out_degrees[np.isfinite(d)[: hg.n]].sum() for d in dists2d
        )
        if bool(np.any(np.asarray(res.sparse_overflowed))):
            print("WARNING: sparse tier overflowed — result untrusted")
        print(f"iterations: {np.asarray(res.num_iterations).tolist()}")
        per = f" ({t.min_s / dists2d.shape[0] * 1e3:.3f} ms/src)" \
            if dists.ndim == 2 else ""
        print(f"elapsed: {t.min_s * 1e3:.3f} ms{per}  "
              f"MTEPS: {t.mteps(edges):.1f}")
        display_device_data(dists2d[0], name="dists")
        if args.validate:
            ok = all(
                validate_exact(d[: hg.n], sssp_cpu(hg, s)[0])
                for d, s in zip(
                    dists2d, srcs if srcs is not None else [args.src]
                )
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "pr":
        from mini_tpu.algorithms import pagerank, pagerank_cpu

        res = pagerank(gs, max_iter=args.max_iter)
        t = time_fn(lambda: pagerank(gs, max_iter=args.max_iter))
        print(f"iterations: {int(res.num_iterations)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        top = np.argsort(-np.asarray(res.ranks))[:10]
        print("top-10:", list(zip(top, np.asarray(res.ranks)[top])))
        if args.validate:
            exp = pagerank_cpu(hg, max_iter=args.max_iter)
            ok = np.allclose(
                np.asarray(res.ranks)[: hg.n], exp, rtol=1e-3, atol=1e-6
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "coloring":
        from mini_tpu.algorithms import coloring, validate_coloring

        res = coloring(
            gs,
            prime=args.prime,
            seed=args.seed,
            hashes_per_round=args.hashes_per_round,
        )
        t = time_fn(
            lambda: coloring(
                gs,
                prime=args.prime,
                seed=args.seed,
                hashes_per_round=args.hashes_per_round,
            )
        )
        colors = np.asarray(res.colors)
        print(
            f"iterations: {int(res.num_iterations)} "
            f"colors used: {len(np.unique(colors[: hg.n]))}"
        )
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            ok = validate_coloring(colors, hg)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "kcore":
        from mini_tpu.algorithms import kcore, kcore_cpu, kcore_cpu_true

        variant = args.kcore_variant
        res = kcore(gs, variant=variant)
        t = time_fn(lambda: kcore(gs, variant=variant))
        print(f"largest k-core: {int(res.largest_k_core)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            effective = (
                ("mini" if hg.directed else "hindex")
                if variant == "auto"
                else variant
            )
            oracle = kcore_cpu if effective == "mini" else kcore_cpu_true
            exp_cores, exp_largest = oracle(hg)
            ok = (
                validate_exact(
                    np.asarray(res.num_cores)[: hg.n], exp_cores
                )
                and int(res.largest_k_core) == exp_largest
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "lspar":
        from mini_tpu.algorithms import lspar

        res = lspar(gs, prime=args.prime, e=args.e, seed=args.seed)
        t = time_fn(lambda: lspar(gs, prime=args.prime, e=args.e,
                                  seed=args.seed))
        print(f"selected edges: {int(res.num_selected)} / {hg.m}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
    elif args.algo == "cc":
        from mini_tpu.algorithms import connected_components, cc_cpu

        res = connected_components(gs)
        t = time_fn(lambda: connected_components(gs))
        print(f"components: {int(res.num_components)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            ok = validate_exact(
                np.asarray(res.components)[: hg.n], cc_cpu(hg)
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "gcn":
        import jax
        import jax.numpy as jnp
        from mini_tpu.models.gcn import (
            gcn_normalize,
            gcn_init,
            gcn_forward,
        )

        norm = gcn_normalize(gs)
        params = gcn_init(jax.random.PRNGKey(args.seed), [128, 128, 32])
        rng = np.random.RandomState(args.seed)
        x = jnp.asarray(rng.rand(gs.n_pad, 128).astype(np.float32))
        fwd = jax.jit(lambda p, xx: gcn_forward(p, gs, norm, xx))
        t = time_fn(lambda: fwd(params, x))
        eps = 2 * hg.m / t.min_s  # 2 layers
        print(f"elapsed: {t.min_s * 1e3:.3f} ms  agg edges/s: {eps:.3e}")
        if args.validate:
            from mini_tpu.models.gcn import gcn_forward_cpu

            params_np = jax.tree_util.tree_map(np.asarray, params)
            exp = gcn_forward_cpu(params_np, hg, np.asarray(x))
            got = np.asarray(fwd(params, x))[: hg.n]
            # f32 device vs f64 oracle; tolerance absorbs the TF32
            # matmuls a GPU uses at default precision
            ok = np.allclose(got, exp, rtol=2e-3, atol=2e-3)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "gat":
        import jax
        import jax.numpy as jnp
        from mini_tpu.models.gat import (
            gat_init, gat_forward, gat_forward_cpu,
        )

        params = gat_init(
            jax.random.PRNGKey(args.seed), [128, 32, 32], heads=args.heads
        )
        rng = np.random.RandomState(args.seed)
        x = jnp.asarray(rng.rand(gs.n_pad, 128).astype(np.float32) * 0.1)
        fwd = jax.jit(lambda p, xx: gat_forward(p, gs, xx))
        t = time_fn(lambda: fwd(params, x))
        eps = 2 * hg.m / t.min_s  # 2 layers
        print(f"elapsed: {t.min_s * 1e3:.3f} ms  agg edges/s: {eps:.3e}")
        if args.validate:
            params_np = jax.tree_util.tree_map(np.asarray, params)
            exp = gat_forward_cpu(params_np, hg, np.asarray(x))
            got = np.asarray(fwd(params, x))[: hg.n]
            # f32 device (TF32 matmuls on a GPU) vs f64 sparse oracle
            ok = np.allclose(got, exp, rtol=2e-3, atol=2e-3)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "sage":
        import jax
        import jax.numpy as jnp
        from mini_tpu.models.sage import (
            sage_init, sage_forward, sage_forward_cpu,
        )

        params = sage_init(jax.random.PRNGKey(args.seed), [128, 128, 32])
        rng = np.random.RandomState(args.seed)
        x = jnp.asarray(rng.rand(gs.n_pad, 128).astype(np.float32))
        fwd = jax.jit(lambda p, xx: sage_forward(p, gs, xx))
        t = time_fn(lambda: fwd(params, x))
        eps = 2 * hg.m / t.min_s
        print(f"elapsed: {t.min_s * 1e3:.3f} ms  agg edges/s: {eps:.3e}")
        if args.validate:
            params_np = jax.tree_util.tree_map(np.asarray, params)
            exp = sage_forward_cpu(params_np, hg, np.asarray(x))
            got = np.asarray(fwd(params, x))[: hg.n]
            ok = np.allclose(got, exp, rtol=2e-3, atol=2e-3)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
