"""What a measurement was taken on: JAX's device and the card's own line.

Every timing this repository prints names its device; on a GPU host that
includes the card's name and power limit (a card set below its maximum
runs slower under load), read by ``nvidia-smi`` in a child process that
stays off JAX.
"""
from __future__ import annotations

import subprocess

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def card_line() -> str | None:
    """``"<name>, <power limit>"`` per card (joined by `` | ``), or None
    where ``nvidia-smi`` is absent or fails."""
    try:
        out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return " | ".join(lines) or None


def device_info() -> dict:
    """JAX's view of the devices plus the card line."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_line()}
