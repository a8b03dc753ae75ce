"""The hash engine's occupancy warning text.

A copy of the JAX package's ``occupancy`` module, cut to its one
consumer here, the hash engine's visited-table watch (checkers/tpu.py
``_maybe_warn_occupancy`` — open addressing degrades before it
overflows, so it warns at 70%), with its byte formatter
(``memplan.format_bytes``) copied in: the warning reads as the JAX
one does, "X% full (n/cap) [bytes of bytes]; what breaks past the
cliff, which knob to turn".
"""

from __future__ import annotations

from typing import Optional

#: the hash-table engine's probe-pressure threshold (open addressing
#: degrades well before it is full).
PROBE_PRESSURE_THRESHOLD = 0.7


def format_bytes(n) -> str:
    """Human-readable byte count ('-' for None)."""
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return (f"{n:,.0f} {unit}" if unit == "B"
                    else f"{n:,.2f} {unit}")
        n /= 1024.0
    return f"{n:,.2f} GB"


def occupancy_warning(occupancy: float, used: int, capacity: int,
                      bytes_per_row: int) -> Optional[str]:
    """The JAX engine's visited-table warning line, or None while
    ``occupancy`` is at or under :data:`PROBE_PRESSURE_THRESHOLD`: the
    fill in rows (``used`` of ``capacity``) and priced in bytes."""
    if occupancy <= PROBE_PRESSURE_THRESHOLD:
        return None
    return (f"visited table {occupancy:.0%} full ({used}/{capacity}) "
            f"[{format_bytes(used * bytes_per_row)} of "
            f"{format_bytes(capacity * bytes_per_row)}]; probe failures "
            "become likely past ~85% — consider a larger capacity")
