"""Typed, introspectable option system.

Analog of the reference's AVOption/AVClass machinery
(libavutil/opt.h:428, opt.c) — the backbone of its config
system (SURVEY.md §5): every configurable component exposes a typed,
range-checked, string-settable option table, which the CLI layer binds to
``-name value`` arguments and the filter-graph parser binds to
``name=value:name2=value2`` strings.

Components declare options declaratively:

    class Scaler(OptionedObject):
        OPTIONS = OptionTable(
            Option("width",  int, 0, alias="w", min=0),
            Option("flags",  str, "bicubic", choices=[...]),
        )

and get parse/set/serialize/introspect for free.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from librempeg_tpu_torch.core.rational import Rational


@dataclass
class Option:
    name: str
    type: type                      # int, float, bool, str, Rational
    default: Any = None
    help: str = ""
    alias: str | None = None        # short alternative name
    min: float = -math.inf
    max: float = math.inf
    choices: dict[str, Any] | Sequence[str] | None = None  # named constants

    def parse(self, value: Any) -> Any:
        """Parse a (possibly string) value into this option's type."""
        if self.choices is not None and isinstance(value, str):
            if isinstance(self.choices, dict):
                if value in self.choices:
                    value = self.choices[value]
                elif self.type is not str:
                    raise ValueError(
                        f"option {self.name}: invalid choice {value!r} "
                        f"(choices: {list(self.choices)})")
            elif value not in self.choices:
                raise ValueError(
                    f"option {self.name}: invalid choice {value!r} "
                    f"(choices: {list(self.choices)})")
        if isinstance(value, str) and self.type is not str:
            value = self._parse_str(value)
        if self.type in (int, float) and not isinstance(value, bool):
            v = self.type(value)
            if not (self.min <= v <= self.max):
                raise ValueError(
                    f"option {self.name}: value {v} out of range "
                    f"[{self.min}, {self.max}]")
            return v
        if self.type is bool and not isinstance(value, bool):
            raise ValueError(f"option {self.name}: expected bool, got {value!r}")
        if self.type is Rational and not isinstance(value, Rational):
            if isinstance(value, (int, float)):
                return Rational.from_float(float(value))
            raise ValueError(f"option {self.name}: cannot parse {value!r}")
        return value

    def _parse_str(self, s: str) -> Any:
        if self.type is bool:
            ls = s.lower()
            if ls in ("1", "true", "yes", "on"):
                return True
            if ls in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"option {self.name}: invalid bool {s!r}")
        if self.type is int:
            # accept SI suffixes like the reference's av_strtod: 128k, 2M
            mult = 1
            body = s
            if s and s[-1] in "kKmMgG":
                mult = {"k": 1000, "K": 1024, "m": 10**6, "M": 1 << 20,
                        "g": 10**9, "G": 1 << 30}[s[-1]]
                body = s[:-1]
            try:
                return int(body, 0) * mult
            except ValueError:
                # arithmetic expressions ("2*3+1") via the eval module
                from librempeg_tpu_torch.core.eval_expr import eval_expr
                return int(eval_expr(s))
        if self.type is float:
            try:
                return float(s)
            except ValueError:
                from librempeg_tpu_torch.core.eval_expr import eval_expr
                return float(eval_expr(s))
        if self.type is Rational:
            if "/" in s:
                n, d = s.split("/", 1)
                return Rational(int(n), int(d))
            if ":" in s:
                n, d = s.split(":", 1)
                return Rational(int(n), int(d))
            return Rational.from_float(float(s))
        return s


class OptionTable:
    def __init__(self, *options: Option):
        self.options = list(options)
        self._by_name: dict[str, Option] = {}
        for o in options:
            self._by_name[o.name] = o
            if o.alias:
                self._by_name[o.alias] = o

    def __iter__(self):
        return iter(self.options)

    def get(self, name: str) -> Option | None:
        return self._by_name.get(name)

    def defaults(self) -> dict[str, Any]:
        return {o.name: o.default for o in self.options}

    def extended(self, *options: Option) -> "OptionTable":
        return OptionTable(*self.options, *options)


class OptionedObject:
    """Base class giving components an option store (AVClass analog)."""

    OPTIONS: OptionTable = OptionTable()

    def __init__(self, **kwargs):
        self.opts: dict[str, Any] = self.OPTIONS.defaults()
        self.set_options(kwargs)

    def set_option(self, name: str, value: Any) -> None:
        o = self.OPTIONS.get(name)
        if o is None:
            raise ValueError(f"{type(self).__name__}: no such option {name!r}")
        self.opts[o.name] = o.parse(value)

    def set_options(self, kv: dict[str, Any]) -> None:
        for k, v in kv.items():
            self.set_option(k, v)

    def get_option(self, name: str) -> Any:
        o = self.OPTIONS.get(name)
        if o is None:
            raise ValueError(f"{type(self).__name__}: no such option {name!r}")
        return self.opts[o.name]


def parse_opt_string(s: str, *, sep: str = ":", kvsep: str = "=") -> dict[str, str]:
    """Parse "a=1:b=2:c=x\\:y" (filter-arg style) into a dict.

    Backslash escapes the separator, matching the reference's
    av_opt_set_from_string quoting rules (simplified: no quoting levels).
    """
    out: dict[str, str] = {}
    if not s:
        return out
    parts: list[str] = []
    cur = []
    esc = False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == sep:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    pos_index = 0
    for p in parts:
        if not p:
            continue
        if kvsep in p:
            k, v = p.split(kvsep, 1)
            out[k] = v
        else:
            # positional (shorthand) arg — caller maps by declared order
            out[f"@{pos_index}"] = p
            pos_index += 1
    return out


def apply_positional(args: dict[str, str], order: Sequence[str]) -> dict[str, str]:
    """Map "@N" positional args onto named options by declared order."""
    out = {}
    for k, v in args.items():
        if k.startswith("@"):
            i = int(k[1:])
            if i >= len(order):
                raise ValueError(f"too many positional arguments: {v!r}")
            out[order[i]] = v
        else:
            out[k] = v
    return out
