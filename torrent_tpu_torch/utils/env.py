"""Environment-variable parsing helpers (shared by tuning knobs)."""

from __future__ import annotations

import os


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Integer env knob: malformed values fall back to ``default``,
    parsed values are clamped to ``minimum``."""
    try:
        return max(minimum, int(os.environ.get(name, default)))
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    """Boolean env knob (0/1/true/false/on/off, case-insensitive).

    NOT ``bool(env_int(name, 0))``: env_int's ``minimum=1`` clamp turns
    a 0 default into 1, silently flipping every "off by default"
    experimental knob ON — caught when the 2-process pallas-kernel test
    tripped the interleave guard with nothing set in the environment.
    Malformed values fall back to ``default``.
    """
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off", ""):
        return False
    return default
