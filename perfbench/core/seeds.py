"""Seeds derived from the run's --seed (any whole number) and a tag."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for torch and numpy generators, the same for the same
    seed and tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
