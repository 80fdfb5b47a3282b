"""What the benchmark and the chip smoke test print about the card.

Every measured number is labelled with the card it came from: the name
and power limit ``nvidia-smi`` reports (a card set below its 700 W limit
runs slower under load) and the device JAX sees. A measurement path that
finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi printed nothing"


def require_gpu() -> Dict[str, object]:
    """Device facts for a GPU run; exits non-zero, printing no result, when
    JAX's first device is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform!r} "
              f"({dev.device_kind}); this measurement runs only on the card",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def run_facts() -> Dict[str, object]:
    """JAX version, XLA flags and compile-cache directory of this run."""
    import jax

    return {"jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compilation_cache_dir": jax.config.jax_compilation_cache_dir}
