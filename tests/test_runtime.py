"""The compile-cache rule: with JAX_COMPILATION_CACHE_DIR set the program
sets no cache directory (JAX honours the variable); without it, compiled
programs go to the fixed `.jax_cache` directory inside the checkout."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from panacus_jax import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, jax, jax.numpy as jnp
from panacus_jax.ops import engine  # configures JAX on import
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.cumsum(x * 3 + 1))(jnp.arange(4096)).block_until_ready()
print(json.dumps(jax.config.jax_compilation_cache_dir))
"""


def _run_probe(env):
    r = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_dir_rule(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert runtime.compile_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert runtime.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_env_cache_dir_receives_compiled_programs(tmp_path):
    cache = tmp_path / "jax-cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache))
    assert _run_probe(env) == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_default_cache_dir_is_in_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _run_probe(env) == runtime.CACHE_DIR
    assert os.path.isdir(runtime.CACHE_DIR) and os.listdir(runtime.CACHE_DIR)
