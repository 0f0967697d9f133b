"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins where set;
otherwise the cache goes to <checkout>/.cache/jax."""

import os

import jax
import pytest

from bignn.utils import compile_cache


@pytest.fixture
def restore_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_is_used_and_nothing_is_set(monkeypatch, tmp_path,
                                                  restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_cache_dir(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(checkout, ".cache", "jax")
    assert jax.config.jax_compilation_cache_dir == path
