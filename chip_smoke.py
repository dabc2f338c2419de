"""Smoke test of mini-tpu on NVIDIA GPUs, through the library's public API.

    python chip_smoke.py            # one GPU: traversals, GNN training, SpMM
    python chip_smoke.py --multi    # four GPUs: the sharded path only

One GPU (default):

* traversal: Graph500 Kronecker graph at scale 22 (A/B/C = 0.57/0.19/0.19,
  edge factor 16, undirected, weighted).  ``bfs`` from 4 seeded roots of
  degree >= 1 against ``bfs_cpu`` (bitwise) and a vectorized predecessor
  check; ``sssp`` (default and ``variant="delta"``) against a vectorized
  float32 Bellman-Ford (bitwise); ``pagerank`` against ``pagerank_cpu``;
  ``connected_components`` against scipy (bitwise);
* GNN: an ogbn-arxiv-shaped synthetic dataset (scale 17, 128 features,
  40 classes).  GCN [128, 256, 256, 40] and GAT [128, 250, 250, 40] x 3
  heads: the forward against the NumPy oracle at "highest" matmul
  precision, then 5 train steps with f32 and 5 with bf16 messages;
* SpMM: ``spmm`` (pull, F = 128, f32 and bf16) in one jitted loop at the
  arxiv shape and at Kronecker scale 20, against a plain device copy.

``--multi`` (needs 4 GPUs): ``dist_bfs`` and ``dist_sssp`` with a
``HaloPlan`` at scale 22 against single-GPU ``bfs``/``sssp`` in the same
process (bitwise), and ``dist_gcn_train`` against ``gcn_train_step``.

Every line before the last names the card and its power limit.  The last
line is one JSON object; any failed check raises, and no platform but
"gpu" is accepted.  The phase functions take their sizes as arguments so
that the tests can run them on the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Relative error bounds for float results (max |got - ref| / max |ref|).
PAGERANK_RTOL = 1e-4  # f32 device sums vs the float64 oracle
FORWARD_RTOL = 1e-4  # f32 forward at "highest" precision vs float64 oracle
DIST_LOSS_RTOL = 1e-4  # sharded vs one-device GCN loss, "highest" precision


def make_say(card: str):
    """A printer that prefixes every line with the card's name and power
    limit."""
    def say(phase: str, msg: str) -> None:
        print(f"[{card}] {phase}: {msg}", flush=True)

    return say


NO_CARD = make_say("no card")


def card_label() -> str:
    """The card's name and power limit, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peak_bytes(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not reported"
    return f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB"


def timed(fn, runs: int = 3):
    """(result, first-call seconds, median seconds of ``runs`` more calls);
    every call ends in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def fmt_times(first: float, median: float) -> str:
    return (
        f"first call {first:.3f} s (compile ~{max(first - median, 0):.3f} s),"
        f" median run {median * 1e3:.2f} ms"
    )


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# ------------------------------------------------------------- oracles
def bellman_ford_f32(hg, src: int) -> np.ndarray:
    """Float32 Bellman-Ford over the CSC edge order, one vectorized pass
    per round.  Every relaxation is ``fl32(dist[u] + w)``, as on the
    device, and the least fixpoint of that monotone map is unique, so the
    result is bitwise what any correct f32 SSSP gives."""
    dist = np.full(hg.n, np.inf, np.float32)
    dist[src] = 0.0
    nonempty = np.diff(hg.col_offsets) > 0
    starts = hg.col_offsets[:-1][nonempty]
    while True:
        cand = dist[hg.csc_srcs] + hg.csc_weights
        new = dist.copy()
        new[nonempty] = np.minimum(dist[nonempty],
                                   np.minimum.reduceat(cand, starts))
        if np.array_equal(new, dist):
            return dist
        dist = new


def cc_oracle(hg) -> np.ndarray:
    """Component labels from scipy, each component named by its minimum
    vertex id."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    adj = sp.csr_matrix(
        (np.ones(hg.m, np.int8), hg.csr_dsts, hg.row_offsets),
        shape=(hg.n, hg.n),
    )
    _, lab = connected_components(adj, directed=True, connection="weak")
    # np.unique's first index of each label is the component's min id
    uniq, first = np.unique(lab, return_index=True)
    min_id = np.empty(uniq.size, np.int32)
    min_id[uniq] = first
    return min_id[lab]


# -------------------------------------------------------------- phases
def device_phase(say=NO_CARD):
    """The devices JAX sees, printed with the JAX version and the compile
    cache directory."""
    import jax

    from mini_tpu.utils.compile_cache import compile_cache_dir

    devices = jax.devices()
    say("device", f"kind {devices[0].device_kind!r}, count {len(devices)},"
                  f" jax {jax.__version__},"
                  f" compile cache {compile_cache_dir()}")
    return devices


def traversal_phase(scale: int = 22, n_roots: int = 4, seed: int = 0,
                    feat: int = 128, say=NO_CARD) -> None:
    import jax
    import jax.numpy as jnp

    from mini_tpu.algorithms import (
        bfs, bfs_cpu, connected_components, pagerank, pagerank_cpu, sssp,
        validate_preds,
    )
    from mini_tpu.graph import GraphSlice, rmat
    from mini_tpu.ops import spmm

    ph = f"traversal rmat{scale}"
    t0 = time.perf_counter()
    hg = rmat(scale, edge_factor=16, seed=seed, undirected=True,
              weighted=True)
    say(ph, f"host graph n={hg.n} m={hg.m} built in"
            f" {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gs = jax.block_until_ready(GraphSlice.from_host(hg))
    say(ph, f"GraphSlice n_pad={gs.n_pad} m_pad={gs.m_pad} on device in"
            f" {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    roots = rng.choice(np.flatnonzero(hg.out_degrees > 0), n_roots,
                       replace=False)
    say(ph, f"roots {roots.tolist()}")

    # host oracles run in threads while the device compiles and runs
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    want_bfs = {int(r): pool.submit(bfs_cpu, hg, int(r)) for r in roots}
    want_sssp = pool.submit(bellman_ford_f32, hg, int(roots[0]))
    pr_kw = dict(max_iter=20, tol_rel=0.0)  # a fixed number of rounds
    want_pr = pool.submit(pagerank_cpu, hg, **pr_kw)
    want_cc = pool.submit(cc_oracle, hg)

    t0 = time.perf_counter()
    bfs_c = jax.jit(bfs).lower(gs, jnp.int32(roots[0])).compile()
    say(ph, f"bfs compiled in {time.perf_counter() - t0:.1f} s;"
            f" memory_analysis: {bfs_c.memory_analysis()}")
    for r in roots:
        res, first, med = timed(lambda r=r: bfs_c(gs, jnp.int32(r)))
        labels = np.asarray(res.labels)[: hg.n]
        want = want_bfs[int(r)].result()
        if not np.array_equal(labels, want):
            raise AssertionError(f"bfs labels differ from bfs_cpu, root {r}")
        if not validate_preds(labels, np.asarray(res.preds), hg, int(r)):
            raise AssertionError(f"bfs predecessors invalid, root {r}")
        edges = float(hg.out_degrees[labels >= 0].sum())
        say(ph, f"bfs root {r}: labels == bfs_cpu, tree valid,"
                f" {int(res.num_iterations)} rounds, {fmt_times(first, med)},"
                f" {edges / med / 1e6:.1f} MTEPS")

    want = want_sssp.result()
    for variant in ("bellman", "delta"):
        res, first, med = timed(
            lambda v=variant: sssp(gs, int(roots[0]), variant=v))
        got = np.asarray(res.dists)[: hg.n]
        if not np.array_equal(got, want):
            bad = int(np.sum(got != want))
            raise AssertionError(f"sssp {variant}: {bad} distances differ")
        say(ph, f"sssp {variant} root {roots[0]}: dists == f32"
                f" Bellman-Ford bitwise, {int(res.num_iterations)} rounds,"
                f" {fmt_times(first, med)}")

    res, first, med = timed(lambda: pagerank(gs, **pr_kw))
    err = rel_err(np.asarray(res.ranks)[: hg.n], want_pr.result())
    if not err <= PAGERANK_RTOL:
        raise AssertionError(f"pagerank rel err {err:.3g} > {PAGERANK_RTOL}")
    say(ph, f"pagerank {int(res.num_iterations)} rounds: rel err {err:.3g}"
            f" <= {PAGERANK_RTOL}, {fmt_times(first, med)}")

    res, first, med = timed(lambda: connected_components(gs))
    if not np.array_equal(np.asarray(res.components)[: hg.n], want_cc.result()):
        raise AssertionError("cc labels differ from scipy")
    say(ph, f"cc: {int(res.num_components)} components == scipy,"
            f" {int(res.num_iterations)} rounds, {fmt_times(first, med)}")
    pool.shutdown()

    # The plain SpMM materializes the m x F message stream; say how large
    # it is at this scale without running it.
    x_shape = jax.ShapeDtypeStruct((gs.n_pad, feat), jnp.float32)
    ma = jax.jit(lambda g, x: spmm(g, x)).lower(gs, x_shape).compile() \
        .memory_analysis()
    say(ph, f"spmm F={feat} f32 at this scale (compiled, not run):"
            f" temp {ma.temp_size_in_bytes / 1e9:.1f} GB; message stream"
            f" m_pad*F*4 = {gs.m_pad * feat * 4 / 1e9:.1f} GB")
    say(ph, f"peak_bytes_in_use so far {peak_bytes(jax.devices()[0])}")


def _arxiv_inputs(scale: int, seed: int):
    import jax.numpy as jnp

    from mini_tpu.graph import GraphSlice
    from mini_tpu.graph.datasets import synthetic_arxiv_like

    ds = synthetic_arxiv_like(scale=scale, seed=seed)
    hg = ds.graph
    gs = GraphSlice.from_host(hg)
    x = np.zeros((gs.n_pad, ds.features.shape[1]), np.float32)
    x[: hg.n] = ds.features
    labels = np.zeros(gs.n_pad, np.int32)
    labels[: hg.n] = ds.labels
    mask = np.zeros(gs.n_pad, bool)
    mask[: hg.n] = ds.train_mask
    return ds, gs, jnp.asarray(x), (jnp.asarray(labels), jnp.asarray(mask))


def _check_forward(say, ph, name, fwd, oracle):
    import jax

    with jax.default_matmul_precision("highest"):
        _, first, med = timed(fwd)
        out = fwd()
    want = oracle()
    n = want.shape[0]
    err = rel_err(np.asarray(out)[:n], want)
    if not err <= FORWARD_RTOL:
        raise AssertionError(f"{name} forward rel err {err:.3g}"
                             f" > {FORWARD_RTOL}")
    _, first_d, med_d = timed(fwd)
    err_d = rel_err(np.asarray(fwd())[:n], want)
    say(ph, f"{name} forward: rel err {err:.3g} <= {FORWARD_RTOL} at"
            f" 'highest' ({fmt_times(first, med)}); {err_d:.3g} at default"
            f" precision ({fmt_times(first_d, med_d)})")


def _check_training(say, ph, name, step, init, steps):
    """``steps`` train steps per message dtype; loss finite and falling."""
    import jax.numpy as jnp

    for mdt in (None, jnp.bfloat16):
        params, opt = init()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, mdt)
            losses.append(float(loss))  # float() waits for the step
            times.append(time.perf_counter() - t0)
        tag = "f32" if mdt is None else "bf16"
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name} {tag} losses {losses}")
        say(ph, f"{name} train {tag} messages: losses"
                f" {[round(v, 4) for v in losses]}; first step"
                f" {times[0]:.2f} s, median of the rest"
                f" {statistics.median(times[1:]) * 1e3:.2f} ms")


def gnn_phase(scale: int = 17, seed: int = 0, steps: int = 5,
              gcn_dims=(128, 256, 256, 40), gat_dims=(128, 250, 250, 40),
              gat_heads: int = 3, lr: float = 0.1, say=NO_CARD) -> None:
    import jax
    import jax.numpy as jnp

    from mini_tpu.models.gat import (
        gat_forward, gat_forward_cpu, gat_init, gat_init_opt, gat_train_step,
    )
    from mini_tpu.models.gcn import (
        gcn_forward, gcn_forward_cpu, gcn_init, gcn_init_opt, gcn_normalize,
        gcn_train_step,
    )

    ds, gs, x, batch = _arxiv_inputs(scale, seed)
    hg = ds.graph
    ph = f"gnn arxiv-like s{scale}"
    say(ph, f"n={hg.n} m={hg.m} features={ds.features.shape[1]}"
            f" classes={ds.num_classes}")
    x_np = np.asarray(x)
    key = jax.random.PRNGKey(seed)

    norm = gcn_normalize(gs)
    gcn_p = gcn_init(key, list(gcn_dims))
    gcn_fwd = jax.jit(lambda p, g, nm, xx: gcn_forward(p, g, nm, xx))
    _check_forward(
        say, ph, f"gcn {list(gcn_dims)}", lambda: gcn_fwd(gcn_p, gs, norm, x),
        lambda: gcn_forward_cpu(jax.tree.map(np.asarray, gcn_p), hg, x_np))

    def gcn_init_state():
        p = gcn_init(key, list(gcn_dims))
        return p, gcn_init_opt(p)

    _check_training(
        say, ph, "gcn",
        lambda p, o, mdt: gcn_train_step(p, o, gs, norm, x, batch, lr=lr,
                                         message_dtype=mdt),
        gcn_init_state, steps)
    del norm, gcn_p

    gat_p = gat_init(key, list(gat_dims), heads=gat_heads)
    gat_fwd = jax.jit(lambda p, g, xx: gat_forward(p, g, xx))
    _check_forward(
        say, ph, f"gat {list(gat_dims)} x{gat_heads} heads",
        lambda: gat_fwd(gat_p, gs, x),
        lambda: gat_forward_cpu(jax.tree.map(np.asarray, gat_p), hg, x_np))

    def gat_init_state():
        p = gat_init(key, list(gat_dims), heads=gat_heads)
        return p, gat_init_opt(p)

    _check_training(
        say, ph, "gat",
        lambda p, o, mdt: gat_train_step(p, o, gs, x, batch, lr=lr,
                                         message_dtype=mdt),
        gat_init_state, steps)
    say(ph, f"peak_bytes_in_use so far {peak_bytes(jax.devices()[0])}")


def _loop_rate(fn, x0, g, iters: int):
    """Median seconds per iteration of ``fn(g, x)`` chained ``iters``
    times inside one jitted loop."""
    import jax

    run = jax.jit(lambda g, x: jax.lax.fori_loop(
        0, iters, lambda i, a: fn(g, a), x))
    _, first, med = timed(lambda: run(g, x0))
    return first, med / iters


def spmm_phase(arxiv_scale: int = 17, rmat_scale: int = 20, feat: int = 128,
               iters: int = 10, copy_mib: int = 2048, seed: int = 0,
               say=NO_CARD) -> None:
    """Device time of the plain ``spmm`` beside a device copy.  Bytes per
    SpMM: one gathered feature row per edge, the edge's source id, dst id
    and weight, and one output row per vertex."""
    import jax
    import jax.numpy as jnp

    from mini_tpu.graph import GraphSlice, rmat
    from mini_tpu.graph.datasets import synthetic_arxiv_like
    from mini_tpu.ops import spmm

    ph = "spmm"
    n_copy = copy_mib * 2**20 // 4
    xc = jnp.zeros(n_copy, jnp.float32)
    _, t = _loop_rate(lambda g, a: a + 1.0, xc, None, iters)
    copy_bps = 2 * n_copy * 4 / t
    say(ph, f"device copy {copy_mib} MiB (read + write): {t * 1e3:.3f} ms,"
            f" {copy_bps / 1e9:.1f} GB/s")
    del xc

    graphs = [
        (f"arxiv-like s{arxiv_scale}",
         lambda: synthetic_arxiv_like(scale=arxiv_scale, seed=seed).graph),
        (f"rmat{rmat_scale}",
         lambda: rmat(rmat_scale, edge_factor=16, seed=seed,
                      undirected=True, weighted=True)),
    ]
    rng = np.random.RandomState(seed)
    for name, make in graphs:
        hg = make()
        gs = GraphSlice.from_host(hg)
        del hg
        x = rng.rand(gs.n_pad, feat).astype(np.float32)
        for dtype in (jnp.float32, jnp.bfloat16):
            item = jnp.dtype(dtype).itemsize
            x0 = jnp.asarray(x, dtype)

            def step(g, a, dtype=dtype):
                return (spmm(g, a) * jnp.asarray(1e-3, a.dtype)).astype(dtype)

            first, t = _loop_rate(step, x0, gs, iters)
            nbytes = gs.m_pad * (feat * item + 12) + gs.n_pad * feat * item
            say(ph, f"{name} m_pad={gs.m_pad} F={feat}"
                    f" {jnp.dtype(dtype).name}: {t * 1e3:.3f} ms per spmm"
                    f" (first loop {first:.2f} s), {nbytes / t / 1e9:.1f}"
                    f" GB/s = {nbytes / t / copy_bps:.3f} of copy")
            del x0
        del gs
    say(ph, f"peak_bytes_in_use so far {peak_bytes(jax.devices()[0])}")


def multi_phase(scale: int = 22, arxiv_scale: int = 17, n_dev: int = 4,
                steps: int = 3, seed: int = 0,
                gcn_dims=(128, 256, 256, 40), lr: float = 0.1,
                say=NO_CARD) -> None:
    """The sharded path on ``n_dev`` devices against one device, in one
    process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mini_tpu.algorithms import bfs, sssp, validate_preds
    from mini_tpu.graph import GraphSlice, rmat
    from mini_tpu.models.gcn import (
        gcn_init, gcn_init_opt, gcn_normalize, gcn_train_step,
    )
    from mini_tpu.parallel import (
        build_halo_plan, dist_sssp, make_dist_bfs, make_mesh,
        partition_graph, shard_to_mesh,
    )
    from mini_tpu.parallel.gcn import dist_gcn_train

    ph = f"multi x{n_dev} rmat{scale}"
    mesh = make_mesh(n_dev)
    hg = rmat(scale, edge_factor=16, seed=seed, undirected=True,
              weighted=True)
    t0 = time.perf_counter()
    pg = partition_graph(hg, n_dev)
    plan = build_halo_plan(pg)
    shards = shard_to_mesh(pg, mesh)
    say(ph, f"n={hg.n} m={hg.m}: partitioned, halo width"
            f" {plan.halo_width}, on the mesh in"
            f" {time.perf_counter() - t0:.1f} s")
    for leaf in jax.tree.leaves(shards)[:1]:
        for shard in leaf.addressable_shards:
            say(ph, f"shard {shard.index} of csc arrays on {shard.device}")
    gs = GraphSlice.from_host(hg)
    root = int(np.random.RandomState(seed).choice(
        np.flatnonzero(hg.out_degrees > 0)))

    one = bfs(gs, root)
    run_bfs = make_dist_bfs(pg, mesh, plan=plan)
    (labels, preds), first, med = timed(lambda: run_bfs(shards, root))
    labels = np.asarray(labels)[: hg.n]
    if not np.array_equal(labels, np.asarray(one.labels)[: hg.n]):
        raise AssertionError("dist_bfs labels differ from bfs")
    if not validate_preds(labels, np.asarray(preds), hg, root):
        raise AssertionError("dist_bfs predecessors invalid")
    say(ph, f"dist_bfs root {root}: labels == one-device bfs, tree valid,"
            f" {fmt_times(first, med)}")

    one = sssp(gs, root)
    t0 = time.perf_counter()
    got = np.asarray(dist_sssp(pg, shards, root, mesh, plan=plan))
    t_sssp = time.perf_counter() - t0
    if not np.array_equal(got[: hg.n], np.asarray(one.dists)[: hg.n]):
        raise AssertionError("dist_sssp dists differ from sssp")
    say(ph, f"dist_sssp root {root}: dists == one-device sssp, one call"
            f" (builds and compiles its program) {t_sssp:.3f} s")
    del gs, shards, plan, pg, hg, one

    ds, _, _, _ = _arxiv_inputs(arxiv_scale, seed)
    hg = ds.graph
    pg = partition_graph(hg, n_dev)
    shards = shard_to_mesh(pg, mesh)
    F = ds.features.shape[1]
    x = np.zeros((pg.n_pad, F), np.float32)
    x[: hg.n] = ds.features
    lab = np.zeros(pg.n_pad, np.int32)
    lab[: hg.n] = ds.labels
    msk = np.zeros(pg.n_pad, bool)
    msk[: hg.n] = ds.train_mask
    row = NamedSharding(mesh, P("graph"))

    def rows(a):
        return jax.device_put(
            jnp.asarray(a.reshape((n_dev, pg.n_loc) + a.shape[1:])), row)

    key = jax.random.PRNGKey(seed)
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        _, dist_losses = dist_gcn_train(
            pg, shards, mesh, gcn_init(key, list(gcn_dims)), rows(x),
            rows(lab), rows(msk), steps=steps, lr=lr)
        t_dist = time.perf_counter() - t0
        gs = GraphSlice.from_host(hg, n_multiple=pg.n_pad)
        norm = gcn_normalize(gs)
        params = gcn_init(key, list(gcn_dims))
        opt = gcn_init_opt(params)
        one_losses = []
        for _ in range(steps):
            params, opt, loss = gcn_train_step(
                params, opt, gs, norm, jnp.asarray(x),
                (jnp.asarray(lab), jnp.asarray(msk)), lr=lr)
            one_losses.append(float(loss))
    err = rel_err(dist_losses, one_losses)
    if not err <= DIST_LOSS_RTOL:
        raise AssertionError(f"dist_gcn_train losses {dist_losses} vs"
                             f" {one_losses}: rel err {err:.3g}")
    say(ph, f"dist_gcn_train arxiv-like s{arxiv_scale} {list(gcn_dims)}:"
            f" losses {[round(v, 5) for v in dist_losses]} match one device"
            f" (rel err {err:.3g} <= {DIST_LOSS_RTOL}), {steps} steps in"
            f" {t_dist:.1f} s with compile")
    for d in jax.devices()[:n_dev]:
        say(ph, f"{d}: peak_bytes_in_use so far {peak_bytes(d)}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the path across 4 GPUs")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    from mini_tpu.utils.compile_cache import enable_compile_cache

    n_dev = 4 if args.multi else 1
    if jax.devices()[0].platform != "gpu" or len(jax.devices()) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPU(s), JAX has {jax.devices()}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = card_label()
    say = make_say(card)
    say("device", f"nvidia-smi name, power.limit: {card}")
    devices = device_phase(say)
    t_all = time.perf_counter()
    phases = (
        [("multi", lambda: multi_phase(seed=args.seed, n_dev=n_dev,
                                       say=say))]
        if args.multi else [
            ("traversal", lambda: traversal_phase(seed=args.seed, say=say)),
            ("gnn", lambda: gnn_phase(seed=args.seed, say=say)),
            ("spmm", lambda: spmm_phase(seed=args.seed, say=say)),
        ]
    )
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        say(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    say("all", f"done in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
