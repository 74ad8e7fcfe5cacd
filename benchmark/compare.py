"""The verdict that decides ``correct``: the worst checked frame's numbers
(each a reference module's ``numbers``) against their limits."""

from __future__ import annotations


def worst(per_frame: list[dict], names) -> dict:
    return {k: max(f[k] for f in per_frame) for k in names}


def verdict(numbers: dict, limits: dict, names) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    return all(numbers[k] <= limits[k] for k in names), out
