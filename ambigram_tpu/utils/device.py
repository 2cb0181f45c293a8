"""What the measurement paths say about the device they ran on.

Every number a benchmark or the chip smoke prints names its device, and
a path that measures the GPU refuses to run anywhere else rather than
quietly timing XLA:CPU.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it, one
    card per "; "-joined entry, or "not available"."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if out.returncode == 0 and lines else "not available"


def require_gpu(devices) -> None:
    """Raise unless `devices` is a non-empty list of GPUs."""
    platforms = sorted({d.platform for d in devices})
    if not devices or platforms != ["gpu"]:
        raise RuntimeError(
            "a GPU is required; JAX found %s"
            % (", ".join(platforms) if platforms else "no devices")
        )


def describe_devices() -> dict:
    """The device as JAX reports it, plus the card's name and power
    limit — a card set below its maximum runs slower under load."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi_name_power(),
    }
