"""What a measurement ran on: the JAX device and, on a GPU, the card."""
from __future__ import annotations

import shutil
import subprocess


def card_info() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it
    ("" where there is no nvidia-smi)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the card."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}
