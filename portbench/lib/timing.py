"""The card's line for the log, copied from ``chip_smoke.card_line``."""
from __future__ import annotations

import subprocess


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
