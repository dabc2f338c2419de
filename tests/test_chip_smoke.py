"""chip_smoke.py on the CPU: every phase at a tiny size, the refusal to run
without GPUs, and the compile-cache location rule."""

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from mini_tpu.utils import compile_cache  # noqa: E402


def test_traversal_phase_tiny(capsys):
    chip_smoke.traversal_phase(scale=8, n_roots=2, feat=8)
    out = capsys.readouterr().out
    assert "labels == bfs_cpu, tree valid" in out
    assert "sssp delta" in out and "components == scipy" in out


def test_gnn_phase_tiny(capsys):
    chip_smoke.gnn_phase(scale=8, steps=3, gcn_dims=(128, 16, 40),
                         gat_dims=(128, 10, 40), gat_heads=3)
    out = capsys.readouterr().out
    assert out.count("train bf16 messages") == 2


def test_spmm_phase_tiny(capsys):
    chip_smoke.spmm_phase(arxiv_scale=8, rmat_scale=8, feat=8, iters=2,
                          copy_mib=1)
    assert capsys.readouterr().out.count("per spmm") == 4


def test_multi_phase_on_four_virtual_devices(capsys):
    chip_smoke.multi_phase(scale=8, arxiv_scale=8, n_dev=4, steps=2,
                           gcn_dims=(128, 16, 40))
    out = capsys.readouterr().out
    assert "labels == one-device bfs" in out
    assert "match one device" in out


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("env, want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, compile_cache.REPO_CACHE_DIR),
])
def test_compile_cache_dir(env, want):
    assert compile_cache.compile_cache_dir(env) == want


def test_repo_cache_dir_is_fixed_in_the_checkout():
    root = pathlib.Path(__file__).resolve().parents[1]
    assert compile_cache.REPO_CACHE_DIR == str(root / ".jax_cache")


def test_enable_compile_cache_sets_dir_only_without_env(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable_compile_cache() == \
            compile_cache.REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == \
            compile_cache.REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", old)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert compile_cache.enable_compile_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
