"""Bytes and peaks: the least time a request could take on the card.

A decode request reads its compressed study once and writes its pixels
once; whatever a kernel reads again, or whatever an implementation keeps
in between, is not counted.  So the bound holds for every implementation
of the decode, and a later change that fuses or removes a kernel still
has one.  The arithmetic is that of the port's kernel bounds (inputs read
once, outputs written once, over the card's memory bandwidth).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str, path: Path = PEAKS) -> dict | None:
    """The published peaks of the card named ``kind``, or None where the
    table does not hold it."""
    return json.loads(path.read_text())["cards"].get(kind)


def request_bytes(blob_sizes, n_pixels: int) -> int:
    """Bytes a request must move: every compressed container read once
    and every u16 pixel written once."""
    return int(sum(blob_sizes)) + 2 * int(n_pixels)


def least_seconds(n_bytes: int, card: dict) -> float:
    """The least time the card could move ``n_bytes`` in."""
    return n_bytes / card["hbm_bytes_per_s"]


def share_pct(least_s: float, busy_s: float) -> float | None:
    """The bound's share of the measured device time, in %; None where
    nothing ran."""
    return 100.0 * least_s / busy_s if busy_s > 0 else None
