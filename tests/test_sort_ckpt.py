"""segment_sort + checkpoint/profiling utility tests."""

import numpy as np
import jax.numpy as jnp

from mini_tpu.graph import erdos_renyi, GraphSlice
from mini_tpu.ops.sort import segment_sort, segment_argsort
from mini_tpu.utils import save_pytree, load_pytree, scope


def test_segment_sort_matches_numpy():
    hg = erdos_renyi(60, 400, seed=0)
    gs = GraphSlice.from_host(hg)
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 100, gs.m_pad).astype(np.int32)
    srcs = np.asarray(gs.csr_srcs)
    for desc in (False, True):
        out = segment_sort(
            jnp.asarray(keys), gs.csr_srcs, descending=desc
        )
        got = np.asarray(out)
        for v in range(hg.n):
            lo, hi = hg.row_offsets[v], hg.row_offsets[v + 1]
            seg = np.sort(keys[lo:hi])
            np.testing.assert_array_equal(
                got[lo:hi], seg[::-1] if desc else seg
            )


def test_segment_sort_payload_and_argsort():
    hg = erdos_renyi(40, 300, seed=1)
    gs = GraphSlice.from_host(hg)
    rng = np.random.RandomState(1)
    keys = rng.rand(gs.m_pad).astype(np.float32)
    payload = np.arange(gs.m_pad, dtype=np.int32)
    k_out, p_out = segment_sort(
        jnp.asarray(keys), gs.csr_srcs, jnp.asarray(payload),
        descending=True,
    )
    np.testing.assert_allclose(
        np.asarray(k_out), keys[np.asarray(p_out)], rtol=0
    )
    order = segment_argsort(jnp.asarray(keys), gs.csr_srcs, descending=True)
    np.testing.assert_array_equal(np.asarray(order), np.asarray(p_out))


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "labels": jnp.arange(10),
        "nested": [{"w": jnp.ones((3, 4)), "b": jnp.zeros(4)}],
        "dist": jnp.array([1.5, jnp.inf]),
    }
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, state)
    like = {
        "labels": jnp.zeros(10, jnp.int32),
        "nested": [{"w": jnp.zeros((3, 4)), "b": jnp.ones(4)}],
        "dist": jnp.zeros(2),
    }
    restored = load_pytree(path, like)
    np.testing.assert_array_equal(
        np.asarray(restored["labels"]), np.arange(10)
    )
    np.testing.assert_array_equal(
        np.asarray(restored["nested"][0]["w"]), np.ones((3, 4))
    )
    assert np.isinf(np.asarray(restored["dist"])[1])


def test_checkpoint_structure_mismatch_raises(tmp_path):
    import pytest

    state = {"a": jnp.arange(4), "b": jnp.ones(3)}
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, state)
    # different key set (same leaf count) -> mismatch must raise (either
    # the version-stable leaf-signature check — jnp.arange is int32,
    # jnp.zeros f32 — or the same-jax-version treedef check)
    with pytest.raises(ValueError, match="mismatch"):
        load_pytree(path, {"a": jnp.zeros(4), "c": jnp.zeros(3)})
    # same leaf shapes/dtypes, different keys -> the key-path (or
    # same-version treedef) structural check catches it
    with pytest.raises(ValueError, match="(key-path|structure) mismatch"):
        load_pytree(
            path,
            {"a": jnp.zeros(4, jnp.int32), "c": jnp.zeros(3)},
        )
    # different leaf count -> must raise, not load garbage
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": jnp.zeros(4)})


def test_checkpoint_cross_version_key_paths(tmp_path):
    # when the stored jax version differs, str(treedef) is
    # skipped — the keystr key-path signature must still catch a key
    # rename with identical leaf count/shape/dtype
    import json
    import pytest

    state = {"a": jnp.zeros(4), "b": jnp.ones(3)}
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, state)
    # simulate a checkpoint written by a different jax version
    data = dict(np.load(path))
    meta = json.loads(data["__treedef__"].tobytes().decode())
    meta["jax_version"] = "0.0.999-other"
    data["__treedef__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(path, **data)
    # same shapes/dtypes, renamed key -> key-path check must fire
    with pytest.raises(ValueError, match="key-path"):
        load_pytree(path, {"a": jnp.zeros(4), "c": jnp.ones(3)})
    # unchanged structure still loads across versions
    restored = load_pytree(path, {"a": jnp.full(4, 9.0), "b": jnp.zeros(3)})
    np.testing.assert_array_equal(np.asarray(restored["a"]), np.zeros(4))


def test_scope_runs():
    with scope("unit-test"):
        x = jnp.ones(4) * 2
    assert float(x.sum()) == 8.0
