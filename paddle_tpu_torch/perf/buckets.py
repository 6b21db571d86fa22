"""Shared shape-bucketing policy (counterpart of
``paddle_tpu/perf/buckets.py``, less ``ShapeBuckets``).

A bucket ladder quantizes a dynamic extent (a prompt length) onto a small
fixed set: callers pad up to ``bucket(n)``. The JAX package does it so XLA
compiles O(#buckets) programs; the port's serving batcher pads the same
way, so a prompt runs through the same shapes (and the same padded
numerics) as in the JAX package, and the prefill sees O(#buckets) shapes.

One ladder type, three construction policies:

  * ``BucketLadder.pow2(lo, hi)``  -- powers of two, the default ladder
    (O(log n) buckets, <= 2x pad waste);
  * ``BucketLadder.fixed(step, hi)`` -- multiples of ``step`` (bounded pad
    waste of ``step - 1``);
  * ``BucketLadder(seq)``          -- custom explicit ladder (strictly
    increasing positive ints).

``bucket(n)`` returns the smallest bucket >= n. Out-of-ladder sizes (``n``
above the top bucket, or ``n <= 0``) return ``n`` unchanged: identity,
never truncation. ``resolve_ladder`` normalizes the specs the serving API
accepts (``"pow2"``, ``"fixed:K"``, a sequence, a ladder, or None).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

__all__ = ["BucketLadder", "resolve_ladder", "pad_amount"]


class BucketLadder:
    """A strictly increasing ladder of sizes with a next-bucket lookup."""

    def __init__(self, buckets: Sequence[int]):
        bs = [int(b) for b in buckets]
        if not bs:
            raise ValueError("bucket ladder must not be empty")
        for lo, hi in zip(bs, bs[1:]):
            if hi <= lo:
                raise ValueError(
                    f"bucket ladder must be strictly increasing, got "
                    f"{bs} ({hi} after {lo})")
        if bs[0] <= 0:
            raise ValueError(f"buckets must be positive, got {bs[0]}")
        self.buckets: Tuple[int, ...] = tuple(bs)

    # -- constructors --------------------------------------------------------
    @classmethod
    def pow2(cls, lo: int = 1, hi: Optional[int] = None) -> "BucketLadder":
        """Powers of two from >= lo up to hi; hi itself is appended when it
        is not a power of two (so a capacity bound is always reachable)."""
        if hi is not None and hi < lo:
            raise ValueError(f"pow2 ladder: hi={hi} < lo={lo}")
        out = []
        b = 1
        while b < lo:
            b *= 2
        top = hi if hi is not None else b << 20
        while b <= top:
            out.append(b)
            b *= 2
        if hi is not None and (not out or out[-1] != hi):
            out.append(hi)
        return cls(out)

    @classmethod
    def fixed(cls, step: int, hi: int) -> "BucketLadder":
        """Multiples of ``step`` up to hi (hi appended if not a multiple)."""
        step = int(step)
        if step <= 0:
            raise ValueError(f"fixed ladder: step must be positive, "
                             f"got {step}")
        out = list(range(step, int(hi) + 1, step))
        if not out or out[-1] != hi:
            out.append(int(hi))
        return cls(out)

    # -- lookup --------------------------------------------------------------
    def bucket(self, n: int) -> int:
        """Smallest bucket >= n; identity for n <= 0 or n above the top
        bucket (degrade to per-size behavior, never truncate)."""
        n = int(n)
        if n <= 0 or n > self.buckets[-1]:
            return n
        # ladders are tiny (< ~32 rungs): linear scan beats bisect setup
        for b in self.buckets:
            if n <= b:
                return b
        return n  # unreachable; kept for safety

    def capped(self, hi: int) -> "BucketLadder":
        """The same ladder truncated to buckets <= hi (hi appended so the
        cap itself is a rung) -- serving caps at ``s_max``."""
        kept = [b for b in self.buckets if b <= hi]
        if not kept or kept[-1] != hi:
            kept.append(int(hi))
        return BucketLadder(kept)

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self):
        return len(self.buckets)

    def __repr__(self):
        return f"BucketLadder({list(self.buckets)})"


LadderSpec = Union[None, str, Sequence[int], BucketLadder]


def resolve_ladder(spec: LadderSpec,
                   hi: Optional[int] = None) -> Optional[BucketLadder]:
    """Normalize the ladder specs adopting APIs accept.

    None -> None (bucketing off); "pow2" -> power-of-two ladder;
    "fixed:K" -> multiples of K; a sequence -> custom ladder; a
    BucketLadder passes through. ``hi`` caps the result (and is required
    for the string policies' upper bound, e.g. serving's ``s_max``).
    """
    if spec is None:
        return None
    if isinstance(spec, BucketLadder):
        return spec.capped(hi) if hi is not None else spec
    if isinstance(spec, str):
        name = spec.strip().lower()
        if name == "pow2":
            if hi is None:
                return BucketLadder.pow2()
            return BucketLadder.pow2(1, hi)
        if name.startswith("fixed:"):
            step = int(name.split(":", 1)[1])
            if hi is None:
                raise ValueError(
                    f"ladder spec {spec!r} needs an upper bound (hi=)")
            return BucketLadder.fixed(step, hi)
        raise ValueError(
            f"unknown ladder spec {spec!r}; expected 'pow2', 'fixed:K', "
            f"a sequence of sizes, or a BucketLadder")
    ladder = BucketLadder(sorted(int(b) for b in spec))
    return ladder.capped(hi) if hi is not None else ladder


def pad_amount(ladder: Optional[BucketLadder], n: int) -> int:
    """Rows/tokens of padding ``bucket(n)`` adds (0 when bucketing is off
    or n is out-of-ladder) -- the waste the ``*_pad_waste`` metrics count."""
    if ladder is None:
        return 0
    return max(0, ladder.bucket(n) - int(n))
