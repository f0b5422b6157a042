"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set (and then
no other directory is set in code), else one fixed directory of the
checkout — never the home directory, a temporary name, a pid or a time."""

import os

import jax
import pytest

from advanced_hpc_lbm_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_dir_wins():
    assert cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_unset_is_one_fixed_dir_in_the_checkout():
    a, b = cache.cache_dir({}), cache.cache_dir({})
    assert a == b == os.path.join(REPO, ".jax_cache")
    assert not a.startswith(os.path.expanduser("~") + os.sep + ".")


def test_fixed_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.fixture()
def updates(monkeypatch):
    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.append((name, value))
    )
    monkeypatch.delenv("LBM_NO_COMPILE_CACHE", raising=False)
    return calls


def test_enable_with_env_sets_no_directory(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable() == str(tmp_path)
    assert all(name != "jax_compilation_cache_dir" for name, _ in updates)


def test_enable_without_env_uses_the_fixed_dir(updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable() == str(cache.CACHE_DIR)
    assert ("jax_compilation_cache_dir", str(cache.CACHE_DIR)) in updates


def test_opt_out(updates, monkeypatch):
    monkeypatch.setenv("LBM_NO_COMPILE_CACHE", "1")
    assert cache.enable() is None
    assert updates == []
