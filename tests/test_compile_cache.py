"""Persistent compilation cache location (blf_tpu.utils.compile_cache)."""

import pathlib

import jax
import pytest

from blf_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def saved_cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_environment_variable_wins(monkeypatch, tmp_path, saved_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, no other directory is set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_and_inside_checkout(monkeypatch,
                                              saved_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache") == str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()
