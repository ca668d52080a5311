"""Runtime validator combinators (reference layer L1: valid.ts, 47 LoC).

Tiny predicates composed into shape checks for untrusted bdecoded data —
the reference's ``obj/arr/inst/or/num/undef`` combinators (valid.ts:7-47)
re-thought for Python: each validator is a callable ``(value) -> bool``.
Used by metainfo parsing and tracker response parsing before any cast.
"""

from __future__ import annotations

from typing import Any, Callable

Validator = Callable[[Any], bool]


def is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def is_bytes(v: Any) -> bool:
    return isinstance(v, bytes)


def is_dict(v: Any) -> bool:
    return isinstance(v, dict)


def num() -> Validator:
    """Matches an integer (valid.ts:45)."""
    return is_int


def bstr() -> Validator:
    """Matches a bytestring (the decode-side analogue of valid.ts `inst`)."""
    return is_bytes


def absent() -> Validator:
    """Matches a missing optional field (valid.ts:47 `undef`)."""
    return lambda v: v is None


def either(*validators: Validator) -> Validator:
    """Matches if any sub-validator matches (valid.ts:41 `or`)."""

    def check(v: Any) -> bool:
        return any(val(v) for val in validators)

    return check


def optional(validator: Validator) -> Validator:
    return either(absent(), validator)


def arr(item: Validator) -> Validator:
    """Matches a list whose every element matches ``item`` (valid.ts:24)."""

    def check(v: Any) -> bool:
        return isinstance(v, list) and all(item(x) for x in v)

    return check


def obj(shape: dict[bytes, Validator], allow_extra: bool = True) -> Validator:
    """Matches a bytes-keyed dict against a field shape (valid.ts:7).

    Optional fields are expressed with :func:`optional`; extra keys are
    allowed by default (torrents carry arbitrary extra fields — the
    reference's ``extra.torrent`` fixture exercises exactly this).
    """

    def check(v: Any) -> bool:
        if not isinstance(v, dict):
            return False
        for key, validator in shape.items():
            if not validator(v.get(key)):
                return False
        if not allow_extra:
            for key in v:
                if key not in shape:
                    return False
        return True

    return check


def fixed_len_bytes(n: int) -> Validator:
    def check(v: Any) -> bool:
        return isinstance(v, bytes) and len(v) == n

    return check


def multiple_len_bytes(n: int) -> Validator:
    """Bytestring whose length is a positive multiple of ``n`` (pieces blob)."""

    def check(v: Any) -> bool:
        return isinstance(v, bytes) and len(v) > 0 and len(v) % n == 0

    return check
