"""What a measurement ran on: the card as ``nvidia-smi`` names it and the
device as JAX reports it.  Every timed line the bench and ``chip_smoke.py``
print carries both."""

import subprocess


def card() -> str:
    """``name, power.limit`` of the first GPU, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (jax-free: safe in a parent process that must not hold the card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except FileNotFoundError:
        return "nvidia-smi missing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        return f"nvidia-smi failed: rc={out.returncode}"
    return lines[0].strip()


def device() -> dict:
    """Platform, device kind and device count as JAX reports them
    (initializes the JAX backend)."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
