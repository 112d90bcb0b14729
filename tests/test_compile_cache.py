"""Persistent compile-cache location: JAX_COMPILATION_CACHE_DIR wins, and
without it the cache sits at one fixed, gitignored path in the checkout."""

import os

import pytest

from strainscan_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    """Run enable_compile_cache afresh, recording jax.config.update calls
    instead of applying them."""
    import jax

    seen = {}
    monkeypatch.setattr(cc, "_DONE", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.__setitem__(name, value))
    return seen


def test_env_var_honoured(monkeypatch, tmp_path, updates):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "cache"))
    assert cc.cache_dir() is None
    cc.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in updates
    assert not (tmp_path / "cache").exists()   # JAX owns that directory


def test_default_dir_is_fixed_inside_checkout(monkeypatch, tmp_path,
                                              updates):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    first = cc.cache_dir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    assert cc.cache_dir() == first == os.path.join(REPO, ".jax_cache")
    cc.enable_compile_cache()
    assert updates["jax_compilation_cache_dir"] == first
    assert os.path.isdir(first)


def test_default_dir_is_gitignored():
    rel = os.path.relpath(cc.DEFAULT_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert rel in ignored
