"""Shared power-of-two bucketing (bounds the number of distinct batch shapes)."""

from __future__ import annotations


def next_pow2(n: int, base: int = 1) -> int:
    """Smallest power of two >= max(n, base) starting from ``base`` (itself
    a power of two). Used for the proposal buckets and the sentence buckets
    of pipeline/runner.py."""
    bucket = base
    while bucket < n:
        bucket *= 2
    return bucket
