"""The one compile-cache helper (apps/common_cli.enable_compile_cache)."""

import os

import jax
import pytest

from radarml_tpu.apps import common_cli


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_variable_wins_and_nothing_is_set(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert common_cli.enable_compile_cache() == "/somewhere/cache"
    assert config_updates == []


def test_default_is_the_checkout_cache(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = common_cli.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()


def test_every_app_enables_it(monkeypatch, config_updates, tmp_path):
    """setup_logging (the first call of every app's main) enables the
    cache, and a failure surfaces instead of being swallowed."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    common_cli.setup_logging(str(tmp_path / "app.log"), "info")
    assert config_updates[0][0] == "jax_compilation_cache_dir"

    def broken(name, value):
        raise RuntimeError("cache unavailable")

    monkeypatch.setattr(jax.config, "update", broken)
    with pytest.raises(RuntimeError, match="cache unavailable"):
        common_cli.setup_logging(None, "info")
