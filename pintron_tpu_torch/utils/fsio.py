"""Fast whole-file text output.

On the container filesystems we target, creating or O_TRUNC-opening a
file costs ~1 ms while an in-place rewrite (open "r+", write, truncate)
costs ~20 µs.  The pipeline writes the same well-known stage artifact
names repeatedly (the stage ABI of the reference, dist-docs/DESIGN.md),
so rewriting in place is the common case and worth the branch.
"""

from __future__ import annotations


def write_text(path: str, text: str) -> None:
    """Replace the contents of ``path`` with ``text`` (create if new)."""
    try:
        f = open(path, "r+", encoding="utf-8", newline="")
    except OSError:
        f = open(path, "w", encoding="utf-8", newline="")
    with f:
        f.write(text)
        f.truncate()
