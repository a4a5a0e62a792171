"""Small sequence helpers with the reference's exact clamping semantics."""

from __future__ import annotations


def real_substring(index: int, length: int, string: str) -> str:
    """util.c:real_substring: negative index clamps to 0 and shortens the
    requested length; reading past the end stops at the terminator."""
    if index < 0:
        length += index
        index = 0
    if length <= 0:
        return ""
    return string[index:index + length]
