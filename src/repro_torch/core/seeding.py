"""Process-stable seed derivation shared by every simulation layer.

``hash(str)`` is salted per interpreter process, so anything seeded with it
reproduces only under a pinned ``PYTHONHASHSEED``; ``zlib.crc32`` is defined
by the bytes alone.  ``dag.instantiate`` (work jitter),
``profiler.profile_node_synthetic`` (measurement noise) and
``tenancy.arrival_times`` (Poisson streams) all derive their RNG seeds here
— ``tests/test_reproducibility.py`` pins the contract across processes.
"""
from __future__ import annotations

import zlib


def stable_seed(name: str) -> int:
    """Deterministic 16-bit seed component for a workflow/node/tenant name."""
    return zlib.crc32(name.encode()) & 0xFFFF
