"""Exact emulation of Rust's `std::time::Duration` arithmetic.

The reference stores hash timestamps as Rust `Duration` values (u64 seconds +
u32 nanoseconds) inside `.needle.dat` files (needle/src/audio/data.rs:22-24)
and computes them with a specific mix of f32/f64 float operations
(needle/src/audio/analyzer.rs:309, 314-318, 378, 390). To keep our on-disk
data and reported times bit/semantics-compatible we reproduce that arithmetic
exactly:

  * ``from_secs_f64`` / ``from_secs_f32`` round the float's exact binary value
    to integer nanoseconds with round-half-to-even (Rust `try_from_secs_f*`).
  * ``as_secs_f32`` is ``secs as f32 + nanos as f32 / 1e9f32`` (all f32 ops).
  * ``mul_f32`` is ``Duration::from_secs_f32(rhs * self.as_secs_f32())``.

All values are stored as a single non-negative integer nanosecond count.
The port's own copy of needle_tpu/duration.py.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

_NANOS_PER_SEC = 1_000_000_000


class Duration:
    """Non-negative duration with Rust `std::time::Duration` semantics."""

    __slots__ = ("_nanos",)

    def __init__(self, secs: int = 0, nanos: int = 0):
        if secs < 0 or nanos < 0:
            raise ValueError("Duration cannot be negative")
        self._nanos = int(secs) * _NANOS_PER_SEC + int(nanos)

    # ---- constructors ----------------------------------------------------

    @classmethod
    def from_nanos(cls, nanos: int) -> "Duration":
        if nanos < 0:
            raise ValueError("Duration cannot be negative")
        d = cls.__new__(cls)
        d._nanos = int(nanos)
        return d

    @classmethod
    def from_millis(cls, millis: int) -> "Duration":
        return cls.from_nanos(int(millis) * 1_000_000)

    @classmethod
    def from_secs(cls, secs: int) -> "Duration":
        return cls.from_nanos(int(secs) * _NANOS_PER_SEC)

    @classmethod
    def from_secs_f64(cls, secs: float) -> "Duration":
        """Rust `Duration::from_secs_f64`: exact binary value of the f64,
        converted to nanoseconds with round-half-to-even."""
        secs = float(secs)
        if not math.isfinite(secs) or secs < 0.0:
            raise ValueError(f"invalid seconds value: {secs}")
        # Fraction(float) is exact; Python round() on Fraction is half-even.
        return cls.from_nanos(round(Fraction(secs) * _NANOS_PER_SEC))

    @classmethod
    def from_secs_f32(cls, secs) -> "Duration":
        """Rust `Duration::from_secs_f32` (exact f32 value, half-even)."""
        v = np.float32(secs)
        if not np.isfinite(v) or v < 0:
            raise ValueError(f"invalid seconds value: {v}")
        return cls.from_nanos(round(Fraction(float(v)) * _NANOS_PER_SEC))

    # ---- accessors ---------------------------------------------------------

    @property
    def secs(self) -> int:
        """Whole seconds (Rust `as_secs`)."""
        return self._nanos // _NANOS_PER_SEC

    @property
    def subsec_nanos(self) -> int:
        return self._nanos % _NANOS_PER_SEC

    def total_nanos(self) -> int:
        return self._nanos

    def as_millis(self) -> int:
        """Rust `as_millis` (truncating)."""
        return self._nanos // 1_000_000

    def as_secs_f64(self) -> float:
        """Rust `as_secs_f64`: secs as f64 + nanos as f64 / 1e9 (f64 ops)."""
        return float(self.secs) + float(self.subsec_nanos) / 1e9

    def as_secs_f32(self) -> np.float32:
        """Rust `as_secs_f32`: secs as f32 + nanos as f32 / 1e9f32 (f32 ops)."""
        return np.float32(self.secs) + np.float32(self.subsec_nanos) / np.float32(
            _NANOS_PER_SEC
        )

    # ---- arithmetic (Rust panics on overflow/negative; we raise) ----------

    def mul_f32(self, rhs) -> "Duration":
        """Rust `Duration::mul_f32`: from_secs_f32(rhs * self.as_secs_f32())."""
        return Duration.from_secs_f32(np.float32(rhs) * self.as_secs_f32())

    def mul_f64(self, rhs: float) -> "Duration":
        return Duration.from_secs_f64(float(rhs) * self.as_secs_f64())

    def __add__(self, other: "Duration") -> "Duration":
        return Duration.from_nanos(self._nanos + other._nanos)

    def __sub__(self, other: "Duration") -> "Duration":
        if other._nanos > self._nanos:
            raise OverflowError("overflow when subtracting durations")
        return Duration.from_nanos(self._nanos - other._nanos)

    def saturating_sub(self, other: "Duration") -> "Duration":
        return Duration.from_nanos(max(0, self._nanos - other._nanos))

    # ---- comparisons -------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, Duration) and self._nanos == other._nanos

    def __lt__(self, other: "Duration") -> bool:
        return self._nanos < other._nanos

    def __le__(self, other: "Duration") -> bool:
        return self._nanos <= other._nanos

    def __gt__(self, other: "Duration") -> bool:
        return self._nanos > other._nanos

    def __ge__(self, other: "Duration") -> bool:
        return self._nanos >= other._nanos

    def __hash__(self) -> int:
        return hash(self._nanos)

    def __bool__(self) -> bool:
        return self._nanos != 0

    def __repr__(self) -> str:
        """Rust Debug-style unit selection: "3.004081566s", "300ms",
        "500µs", "700ns" (Duration::ZERO prints "0ns")."""
        s, n = self.secs, self.subsec_nanos
        if s > 0:
            if n == 0:
                return f"{s}s"
            return f"{s}.{n:09d}".rstrip("0") + "s"
        if n == 0:
            return "0ns"
        for unit, scale in (("ms", 1_000_000), ("µs", 1_000)):
            if n >= scale:
                whole, frac = divmod(n, scale)
                if frac == 0:
                    return f"{whole}{unit}"
                width = 6 if unit == "ms" else 3
                return f"{whole}.{frac:0{width}d}".rstrip("0") + unit
        return f"{n}ns"


ZERO = Duration.from_nanos(0)
