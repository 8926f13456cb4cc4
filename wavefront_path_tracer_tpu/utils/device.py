"""What a run is on: JAX's device view plus the card's own report.

Every measurement this repo prints carries these fields, so no number is
ever read without the device it came from.  A card may run below its
maximum power limit, and then runs slower under load, so the limit is
part of the record.
"""

from __future__ import annotations

import shutil
import subprocess

SMI_QUERY = ["--query-gpu=name,power.limit", "--format=csv,noheader"]


def card_info() -> dict:
    """``nvidia-smi``'s name and power limit of the first card.

    ``smi`` holds the tool's output as it printed it (one line per
    card).  All three are None where ``nvidia-smi`` is not installed (a
    CPU-only host); a tool that is present but fails raises.
    """
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {"name": None, "power_limit": None, "smi": None}
    out = subprocess.run([exe, *SMI_QUERY], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    name, limit = (f.strip() for f in out.splitlines()[0].split(",", 1))
    return {"name": name, "power_limit": limit, "smi": out}


def device_info() -> dict:
    """JAX's platform, device kind and device count, plus ``card_info``."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        **card_info(),
    }
