"""Test harness: run everything on a virtual 8-device CPU mesh.

Mirrors SURVEY.md §4: distributed tests without a real cluster via
``--xla_force_host_platform_device_count=8``. Must run before jax imports.
``chip_smoke.py`` sets ``CXR_TESTS_ON_DEVICE=1`` to run the tests marked
``gpu`` on the card in its own process instead.

JAX's persistent compilation cache is off for the suite (tests write
nothing into the checkout); the ``persistent_cache`` fixture turns it on
for the tests of the cache itself.
"""

import os

if os.environ.get("CXR_TESTS_ON_DEVICE") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
# Keep CPU tests deterministic and quiet.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
# etils epath picks its gs:// backend ONCE at import: force the
# fsspec/gcsfs backend (honors STORAGE_EMULATOR_HOST) before anything —
# orbax, another test — imports etils, or the GCS-emulator checkpoint
# tests get the tf-gfile backend whose endpoint is unoverridable.
os.environ.setdefault("EPATH_USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first JAX device, for tests marked ``gpu``; skips elsewhere.
    Decided here, when the test runs — never at import or collection, so
    every pytest-xdist worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (first device is {dev.platform}); "
                    f"run on the card by chip_smoke.py")
    return dev


@pytest.fixture
def persistent_cache():
    """JAX's persistent compilation cache on for one test; the process-wide
    cache config is restored afterwards."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = (jax.config.jax_enable_compilation_cache,
              jax.config.jax_compilation_cache_dir)
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before[0])
    jax.config.update("jax_compilation_cache_dir", before[1])
    cc.reset_cache()
