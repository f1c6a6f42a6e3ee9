"""Exact rational arithmetic for timebases and timestamps.

Behavioral analog of the reference's AVRational layer
(libavutil/rational.h, mathematics.c — av_rescale_q,
av_compare_ts, av_reduce). Implemented on Python ints (arbitrary
precision), so rescaling never overflows; rounding modes mirror the
reference's AVRounding semantics so muxer interleaving and timestamp
fixup behave identically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import IntEnum


class Rounding(IntEnum):
    """Rounding modes (analog of AVRounding, libavutil/mathematics.h:79)."""

    ZERO = 0        # toward zero
    INF = 1         # away from zero
    DOWN = 2        # toward -inf
    UP = 3          # toward +inf
    NEAR_INF = 5    # nearest, halfway away from zero
    PASS_MINMAX = 8192  # flag: pass INT64_MIN/MAX through unchanged


INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

#: "No timestamp" sentinel (AV_NOPTS_VALUE, libavutil/avutil.h:248)
NOPTS = INT64_MIN


@dataclass(frozen=True, slots=True)
class Rational:
    """An exact rational number num/den.

    Unlike fractions.Fraction, construction does NOT reduce by default
    (matching AVRational, where e.g. a 1001/48000 timebase keeps its
    representation) but comparisons and arithmetic are exact.
    """

    num: int
    den: int

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_float(x: float, max_den: int = 1 << 30) -> "Rational":
        """Best rational approximation (analog of av_d2q)."""
        if x != x:  # NaN
            return Rational(0, 0)
        if x == float("inf"):
            return Rational(1, 0)
        if x == float("-inf"):
            return Rational(-1, 0)
        from fractions import Fraction

        f = Fraction(x).limit_denominator(max_den)
        return Rational(f.numerator, f.denominator)

    # -- predicates ---------------------------------------------------
    def __bool__(self) -> bool:
        return self.num != 0

    @property
    def valid(self) -> bool:
        return self.den != 0

    # -- arithmetic (exact; results reduced) --------------------------
    def reduce(self) -> "Rational":
        if self.den == 0:
            return Rational(0 if self.num == 0 else (1 if self.num > 0 else -1), 0)
        g = math.gcd(self.num, self.den)
        n, d = self.num // g, self.den // g
        if d < 0:
            n, d = -n, -d
        return Rational(n, d)

    def __mul__(self, other: "Rational | int") -> "Rational":
        if isinstance(other, int):
            other = Rational(other, 1)
        return Rational(self.num * other.num, self.den * other.den).reduce()

    def __truediv__(self, other: "Rational | int") -> "Rational":
        if isinstance(other, int):
            other = Rational(other, 1)
        return Rational(self.num * other.den, self.den * other.num).reduce()

    def __add__(self, other: "Rational | int") -> "Rational":
        if isinstance(other, int):
            other = Rational(other, 1)
        return Rational(
            self.num * other.den + other.num * self.den, self.den * other.den
        ).reduce()

    def __sub__(self, other: "Rational | int") -> "Rational":
        if isinstance(other, int):
            other = Rational(other, 1)
        return Rational(
            self.num * other.den - other.num * self.den, self.den * other.den
        ).reduce()

    def inv(self) -> "Rational":
        return Rational(self.den, self.num)

    def __float__(self) -> float:
        if self.den == 0:
            return math.inf if self.num > 0 else (-math.inf if self.num else math.nan)
        return self.num / self.den

    # -- ordering -----------------------------------------------------
    def _cmp_key(self):
        return self.num * (1 if self.den >= 0 else -1), abs(self.den)

    def __lt__(self, other: "Rational") -> bool:
        return self.num * other.den < other.num * self.den

    def __le__(self, other: "Rational") -> bool:
        return self.num * other.den <= other.num * self.den

    def __eq__(self, other: object) -> bool:
        if isinstance(other, int):
            other = Rational(other, 1)
        if not isinstance(other, Rational):
            return NotImplemented
        if self.den == 0 or other.den == 0:
            # compare reduced (num, den) values so equal infinities/NaN
            # forms compare equal (av_cmp_q semantics), consistent with
            # __hash__
            a, b = self.reduce(), other.reduce()
            return (a.num, a.den) == (b.num, b.den)
        return self.num * other.den == other.num * self.den

    def __hash__(self) -> int:
        r = self.reduce()
        return hash((r.num, r.den))

    def __repr__(self) -> str:
        return f"{self.num}/{self.den}"


#: Common timebases
TIME_BASE = Rational(1, 1_000_000)  # microseconds (AV_TIME_BASE_Q)


def _round_div(a: int, b: int, rnd: int) -> int:
    """Integer division of a by b (b > 0) with explicit rounding mode."""
    q, r = divmod(a, b)  # Python: floor division, 0 <= r < b
    if r == 0:
        return q
    base = rnd & ~Rounding.PASS_MINMAX
    if base == Rounding.DOWN:
        return q
    if base == Rounding.UP:
        return q + 1
    if base == Rounding.ZERO:
        return q if a >= 0 else q + 1
    if base == Rounding.INF:
        return q + 1 if a >= 0 else q
    # NEAR_INF: nearest, ties away from zero
    if 2 * r > b:
        return q + 1
    if 2 * r < b:
        return q
    return q + 1 if a >= 0 else q  # tie


def rescale_rnd(a: int, b: int, c: int, rnd: int = Rounding.NEAR_INF) -> int:
    """a * b / c with explicit rounding (av_rescale_rnd, mathematics.c:60).

    Exact (Python ints don't overflow). Honors PASS_MINMAX.
    """
    if c == 0:
        raise ZeroDivisionError("rescale with zero divisor")
    if (rnd & Rounding.PASS_MINMAX) and a in (INT64_MIN, INT64_MAX):
        return a
    if c < 0:
        b, c = -b, -c
    return _round_div(a * b, c, rnd & ~Rounding.PASS_MINMAX)


def rescale(a: int, b: int, c: int) -> int:
    """a * b / c rounding to nearest (av_rescale)."""
    return rescale_rnd(a, b, c, Rounding.NEAR_INF)


def rescale_q_rnd(a: int, bq: Rational, cq: Rational, rnd: Rounding = Rounding.NEAR_INF) -> int:
    """Rescale a timestamp from timebase bq to cq (av_rescale_q_rnd)."""
    b = bq.num * cq.den
    c = cq.num * bq.den
    return rescale_rnd(a, b, c, rnd)


def rescale_q(a: int, bq: Rational, cq: Rational) -> int:
    return rescale_q_rnd(a, bq, cq, Rounding.NEAR_INF)


def compare_ts(ts_a: int, tb_a: Rational, ts_b: int, tb_b: Rational) -> int:
    """-1/0/1 if ts_a is before/equal/after ts_b (av_compare_ts)."""
    a = ts_a * tb_a.num * tb_b.den
    b = ts_b * tb_b.num * tb_a.den
    return (a > b) - (a < b)
