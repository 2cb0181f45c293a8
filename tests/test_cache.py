"""Persistent-compilation-cache wiring (utils/cache.py): JAX's own
`JAX_COMPILATION_CACHE_DIR` wins; otherwise one fixed in-checkout path."""

import os

import pytest

import ambigram_tpu.utils.cache as cache_mod


@pytest.fixture(autouse=True)
def _restore_jax_cache_config():
    """Restore the cache config so no later test compiles into a
    directory a test pointed it at."""
    import jax

    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_dir_is_left_to_jax(tmp_path, monkeypatch):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    assert cache_mod.enable_compilation_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_default_is_fixed_in_checkout_path(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cache_mod.enable_compilation_cache()
    second = cache_mod.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == second == os.path.join(repo, ".jax_cache")
    assert os.path.isdir(first)
    assert jax.config.jax_compilation_cache_dir == first


def test_read_only_checkout_disables_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(cache_mod, "CACHE_DIR", str(blocker / ".jax_cache"))
    assert cache_mod.enable_compilation_cache() == ""
