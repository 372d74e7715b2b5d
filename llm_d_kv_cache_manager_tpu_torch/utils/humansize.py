"""Human-readable byte-size parsing ("2GiB", "512 MB").

Copy of the reference package's `utils/humansize.py`, the size parser of
the cost-aware index's budget. Supports decimal (kB/MB/GB/TB) and binary
(KiB/MiB/GiB/TiB) units.
"""

from __future__ import annotations

import re

_UNITS = {
    "": 1,
    "b": 1,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12, "pb": 10**15,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40, "pib": 2**50,
    "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12,
}

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def parse_human_size(text: str | int | float) -> int:
    """Parse a human-readable size into bytes. Ints/floats pass through."""
    if isinstance(text, (int, float)):
        return int(text)
    m = _SIZE_RE.match(text)
    if not m:
        raise ValueError(f"unparseable size: {text!r}")
    value, unit = float(m.group(1)), m.group(2).lower()
    if unit not in _UNITS:
        raise ValueError(f"unknown size unit {m.group(2)!r} in {text!r}")
    return int(value * _UNITS[unit])
