"""Arithmetic expression evaluator for option/filter arguments.

Analog of libavutil/eval.c (av_expr_parse/av_expr_eval):
filters accept expressions like ``scale=w=iw/2:h=-1`` or
``crop=x=(in_w-out_w)/2``. Implements the operator set and the commonly
used functions/constants on Python floats via a recursive-descent parser.
Expressions can be parsed once and evaluated many times with different
variable bindings (the reference's two-phase API).
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

_CONSTANTS = {
    "PI": math.pi,
    "E": math.e,
    "PHI": (1 + 5 ** 0.5) / 2,
    "NAN": math.nan,
    "INF": math.inf,
}

_FUNCS1: dict[str, Callable[[float], float]] = {
    "abs": abs,
    "ceil": math.ceil,
    "floor": math.floor,
    "round": round,
    "trunc": math.trunc,
    "sqrt": math.sqrt,
    "exp": math.exp,
    "log": math.log,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "asin": math.asin,
    "acos": math.acos,
    "atan": math.atan,
    "sinh": math.sinh,
    "cosh": math.cosh,
    "tanh": math.tanh,
    "isnan": lambda x: 1.0 if math.isnan(x) else 0.0,
    "isinf": lambda x: 1.0 if math.isinf(x) else 0.0,
    "not": lambda x: 1.0 if x == 0 else 0.0,
    "signum": lambda x: (x > 0) - (x < 0),
}

_FUNCS2: dict[str, Callable[[float, float], float]] = {
    "min": min,
    "max": max,
    "pow": math.pow,
    "hypot": math.hypot,
    "atan2": math.atan2,
    "mod": math.fmod,
    "gcd": lambda a, b: float(math.gcd(int(a), int(b))),
    "eq": lambda a, b: 1.0 if a == b else 0.0,
    "gt": lambda a, b: 1.0 if a > b else 0.0,
    "gte": lambda a, b: 1.0 if a >= b else 0.0,
    "lt": lambda a, b: 1.0 if a < b else 0.0,
    "lte": lambda a, b: 1.0 if a <= b else 0.0,
    "bitand": lambda a, b: float(int(a) & int(b)),
    "bitor": lambda a, b: float(int(a) | int(b)),
    "trunc2": lambda a, b: a,
}


class _Parser:
    def __init__(self, s: str, vars: Mapping[str, float]):
        self.s = s.replace(" ", "")
        self.i = 0
        self.vars = vars

    def peek(self) -> str:
        # "\0" sentinel at end-of-input: never satisfies any `in`/isdigit
        # test ("" would — `"" in ".eE"` is True in Python).
        return self.s[self.i] if self.i < len(self.s) else "\0"

    def eat(self, ch: str) -> None:
        if self.peek() != ch:
            raise ValueError(f"expected {ch!r} at pos {self.i} in {self.s!r}")
        self.i += 1

    # grammar: expr := term (('+'|'-') term)*
    #          term := factor (('*'|'/'|'%') factor)*
    #          factor := unary ('^' factor)?       (right assoc)
    #          unary := ('+'|'-'|'!')* atom
    #          atom := number | name | name '(' expr (',' expr)* ')' | '(' expr ')'
    def parse(self) -> float:
        v = self.expr()
        if self.i != len(self.s):
            raise ValueError(f"trailing garbage at pos {self.i} in {self.s!r}")
        return v

    def expr(self) -> float:
        v = self.term()
        while self.peek() in "+-":
            op = self.peek()
            self.i += 1
            rhs = self.term()
            v = v + rhs if op == "+" else v - rhs
        return v

    def term(self) -> float:
        v = self.factor()
        while self.peek() in "*/%":
            op = self.peek()
            self.i += 1
            rhs = self.factor()
            if op == "*":
                v = v * rhs
            elif op == "/":
                v = v / rhs if rhs != 0 else math.copysign(math.inf, v) if v else math.nan
            else:
                v = math.fmod(v, rhs)
        return v

    def factor(self) -> float:
        v = self.unary()
        if self.peek() == "^":
            self.i += 1
            v = v ** self.factor()
        return v

    def unary(self) -> float:
        if self.peek() == "-":
            self.i += 1
            return -self.unary()
        if self.peek() == "+":
            self.i += 1
            return self.unary()
        if self.peek() == "!":
            self.i += 1
            return 1.0 if self.unary() == 0 else 0.0
        return self.atom()

    def atom(self) -> float:
        if self.peek() == "(":
            self.eat("(")
            v = self.expr()
            self.eat(")")
            return v
        j = self.i
        # number?
        if self.peek().isdigit() or self.peek() == ".":
            while self.peek().isdigit() or self.peek() in ".eE" or (
                self.peek() in "+-" and self.s[self.i - 1] in "eE"
            ):
                self.i += 1
            return float(self.s[j:self.i])
        # identifier
        while self.peek().isalnum() or self.peek() == "_":
            self.i += 1
        name = self.s[j:self.i]
        if not name:
            raise ValueError(f"unexpected character at pos {self.i} in {self.s!r}")
        if self.peek() == "(":
            self.eat("(")
            args = [self.expr()]
            while self.peek() == ",":
                self.i += 1
                args.append(self.expr())
            self.eat(")")
            if name == "if":
                return args[1] if args[0] != 0 else (args[2] if len(args) > 2 else 0.0)
            if name == "ifnot":
                return args[1] if args[0] == 0 else (args[2] if len(args) > 2 else 0.0)
            if name == "clip":
                return min(max(args[0], args[1]), args[2])
            if name in _FUNCS1 and len(args) == 1:
                return float(_FUNCS1[name](args[0]))
            if name in _FUNCS2 and len(args) == 2:
                return float(_FUNCS2[name](args[0], args[1]))
            raise ValueError(f"unknown function {name}/{len(args)}")
        if name in self.vars:
            return float(self.vars[name])
        if name in _CONSTANTS:
            return _CONSTANTS[name]
        raise ValueError(f"unknown identifier {name!r} in {self.s!r}")


def eval_expr(s: str, variables: Mapping[str, float] | None = None) -> float:
    """Evaluate expression `s` with the given variable bindings."""
    return _Parser(s, variables or {}).parse()
