"""The GPU guard and card description shared by the smoke test and the
benchmarks: both refuse to run without a GPU and name the card they ran on."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, one
    line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def require_gpu(program: str) -> None:
    """Exit with a message naming ``program`` unless JAX's first device is a
    GPU."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"{program} needs a GPU; JAX found no GPU (platform "
            f"{platform!r})")
