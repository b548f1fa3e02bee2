"""Placement of JAX's persistent compilation cache
(core/compile_cache.py): the environment's directory when
JAX_COMPILATION_CACHE_DIR is set, else a fixed <checkout>/.jax_cache."""

import os
import subprocess
import sys
import tempfile

import jax

from foamtpu.core import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore():
    compile_cache.configure()


def test_env_directory_is_used_exactly(monkeypatch, tmp_path):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert compile_cache.configure() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        monkeypatch.undo()
        _restore()


def test_unset_env_uses_checkout_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.configure()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        monkeypatch.undo()
        _restore()


def test_default_path_is_fixed_not_temporary(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert str(os.getpid()) not in path
    assert not path.startswith(os.path.realpath(tempfile.gettempdir()))
    assert not path.startswith("/tmp")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    other = subprocess.run(
        [sys.executable, "-c",
         "from foamtpu.core import compile_cache as c; "
         "print(c.cache_dir())"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True)
    assert other.stdout.strip() == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compiled_entries_land_in_env_directory(tmp_path):
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    code = ("import jax, jax.numpy as jnp\n"
            "from foamtpu.core import compile_cache\n"
            "compile_cache.configure()\n"
            "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, capture_output=True)
    assert cache.is_dir() and any(cache.iterdir())
