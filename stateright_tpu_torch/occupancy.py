"""The one home of occupancy and headroom warning text.

A copy of the JAX package's ``occupancy`` module. Consumers that watch
a fixed-capacity device buffer fill up share one warning shape — "X%
full (n/cap) [bytes of bytes]; what breaks past the cliff, which knob
to turn":

* the hash engine's visited-table watch (checkers/tpu.py
  ``_maybe_warn_occupancy`` — open addressing degrades before it
  overflows, so it warns at :data:`PROBE_PRESSURE_THRESHOLD`);
* exact-capacity buffers (the sorted visited arrays), where nothing
  degrades before 100% but one skewed wave past
  :data:`HEADROOM_THRESHOLD` can overflow.

The byte pricing goes through the one formatter, ``memplan.format_bytes``.
"""

from __future__ import annotations

from typing import Optional

#: the hash-table engine's probe-pressure threshold (open addressing
#: degrades well before it is full).
PROBE_PRESSURE_THRESHOLD = 0.7

#: headroom threshold for EXACT-capacity buffers (the sorted visited
#: arrays): nothing degrades before 100%, but past this fill one skewed
#: wave can overflow.
HEADROOM_THRESHOLD = 0.8


def occupancy_warning(
    occupancy: float,
    *,
    kind: str = "visited table",
    threshold: float = PROBE_PRESSURE_THRESHOLD,
    used: Optional[int] = None,
    capacity: Optional[int] = None,
    bytes_per_row: Optional[int] = None,
    consequence: str = (
        "probe failures become likely past ~85% — consider a larger "
        "capacity"
    ),
) -> Optional[str]:
    """The warning line, or None while ``occupancy`` is at or under
    ``threshold``. ``used``/``capacity`` add the counts in rows;
    ``bytes_per_row`` also prices them in bytes (what the fill weighs
    and what the full buffer would); ``consequence`` names what breaks
    and which knob fixes it."""
    if occupancy <= threshold:
        return None
    detail = (
        f" ({used}/{capacity})"
        if used is not None and capacity is not None
        else ""
    )
    if (bytes_per_row is not None and used is not None
            and capacity is not None):
        from .memplan import format_bytes

        detail += (
            f" [{format_bytes(used * bytes_per_row)} of "
            f"{format_bytes(capacity * bytes_per_row)}]"
        )
    return f"{kind} {occupancy:.0%} full{detail}; {consequence}"
