"""Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
when set (and nothing else), else the caller's directory, else the fixed
<checkout>/.xla_cache."""

import os

import jax

from chestxray_vit_tpu.utils import compilation_cache as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_over_explicit(monkeypatch, tmp_path):
    monkeypatch.setenv(C.ENV_VAR, str(tmp_path / "env"))
    assert C.cache_dir(str(tmp_path / "explicit")) == str(tmp_path / "env")
    assert C.cache_dir() == str(tmp_path / "env")


def test_explicit_dir_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv(C.ENV_VAR, raising=False)
    assert C.cache_dir(str(tmp_path / "x")) == str(tmp_path / "x")
    assert C.cache_dir("gs://bucket/cache") == "gs://bucket/cache"


def test_default_is_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv(C.ENV_VAR, raising=False)
    assert C.cache_dir() == C.cache_dir(None) == os.path.join(REPO,
                                                               ".xla_cache")


def test_enable_points_jax_at_the_dir_and_caches(monkeypatch, tmp_path,
                                                 persistent_cache):
    monkeypatch.delenv(C.ENV_VAR, raising=False)
    path = C.enable_compilation_cache(str(tmp_path / "c"))
    assert path == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == path
    jax.jit(lambda x: x * 3.0 + 1.0)(jax.numpy.ones(7)).block_until_ready()
    assert os.listdir(path), "nothing was cached"
