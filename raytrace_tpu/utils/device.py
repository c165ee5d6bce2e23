"""Identify the accelerator a measurement ran on.

Every timing this repository prints names the device it ran on: JAX's
platform, device kind and device count, and the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load, so two numbers are comparable only beside the
same limit).
"""

from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of every visible card, one per line, or
    ``"not available"`` where ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    return out.stdout.strip() if out.returncode == 0 else "not available"


def jax_device() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's first device, as the
    last line of ``chip_smoke.py`` and every bench result report it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """The device dict, or SystemExit when JAX found no GPU: timings
    taken on another backend are never reported as device numbers."""
    dev = jax_device()
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev['platform']}"
                         f" ({dev['kind']}); refusing to measure")
    return dev
