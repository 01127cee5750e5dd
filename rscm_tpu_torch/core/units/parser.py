"""
Flexible unit-string parser.

Mirror of ``crates/rscm-core/src/units/parser.rs``: accepts equivalent
notations — exponents ``m^2`` / ``m**2`` / ``m2``, division ``W/m^2`` /
``W m^-2`` / ``W per m^2``, multiplication ``kg m`` / ``kg*m`` — and
normalises to a canonical ``num / den`` string keyed by a sorted component
map.

Deliberate reference-parity behaviours (upstream's parser does the same;
the compat contract pins them): ``parse`` stops at the first character no
rule consumes without requiring end-of-input (``parser.rs:98-113`` calls
``parse_expression`` with no trailing check), and a whitespace-separated
bare digit is an exponent (``parse_optional_exponent`` skips whitespace
first, ``parser.rs:396-397`` — the grammar's ``('^'|'**')?`` marker is
optional).  Alias resolution happens at registry lookup, not parse time,
so ``Unit("year") != Unit("yr")`` even though their conversion factor is
exactly 1 (``parser.rs`` components vs ``registry.rs`` aliases).
"""

from __future__ import annotations

from typing import Dict

from .dimension import Dimension
from .registry import UNIT_REGISTRY

__all__ = ["ParseError", "ParsedUnit"]


class ParseError(ValueError):
    @staticmethod
    def empty_unit():
        return ParseError("empty unit string")

    @staticmethod
    def unknown_unit(u: str):
        return ParseError(f"unknown unit: '{u}'")

    @staticmethod
    def invalid_exponent(e: str):
        return ParseError(f"invalid exponent: '{e}'")

    @staticmethod
    def parse_failed(msg: str):
        return ParseError(f"parse failed: {msg}")


class ParsedUnit:
    """A unit expression as a map of symbol -> integer exponent."""

    __slots__ = ("_components",)

    def __init__(self, components: Dict[str, int] = None):
        components = components or {}
        self._components = {k: v for k, v in sorted(components.items()) if v != 0}

    @staticmethod
    def dimensionless() -> "ParsedUnit":
        return ParsedUnit()

    @staticmethod
    def parse(text: str) -> "ParsedUnit":
        text = text.strip()
        if not text:
            raise ParseError.empty_unit()
        if text == "1" or text.lower() == "dimensionless":
            return ParsedUnit.dimensionless()
        return _UnitParser(text).parse_expression()

    def components(self) -> Dict[str, int]:
        return dict(self._components)

    def has_no_components(self) -> bool:
        return not self._components

    def dimension(self) -> Dimension:
        result = Dimension.dimensionless()
        for symbol, exp in self._components.items():
            info = UNIT_REGISTRY.lookup(symbol)
            if info is None:
                raise ParseError.unknown_unit(symbol)
            result = result + info.dimension.pow(exp)
        return result

    def is_dimensionless(self) -> bool:
        return self.dimension().is_dimensionless()

    def to_si_factor(self) -> float:
        factor = 1.0
        for symbol, exp in self._components.items():
            info = UNIT_REGISTRY.lookup(symbol)
            if info is None:
                raise ParseError.unknown_unit(symbol)
            factor *= info.to_si_factor**exp
        return factor

    def multiply(self, other: "ParsedUnit") -> "ParsedUnit":
        out = dict(self._components)
        for symbol, exp in other._components.items():
            out[symbol] = out.get(symbol, 0) + exp
        return ParsedUnit(out)

    def divide(self, other: "ParsedUnit") -> "ParsedUnit":
        out = dict(self._components)
        for symbol, exp in other._components.items():
            out[symbol] = out.get(symbol, 0) - exp
        return ParsedUnit(out)

    def pow(self, exp: int) -> "ParsedUnit":
        return ParsedUnit({k: v * exp for k, v in self._components.items()})

    def normalized(self) -> str:
        if not self._components:
            return "1"
        numerator = [(s, e) for s, e in self._components.items() if e > 0]
        denominator = [(s, -e) for s, e in self._components.items() if e < 0]

        def fmt(parts):
            return " ".join(s if e == 1 else f"{s}^{e}" for s, e in sorted(parts))

        num_str, den_str = fmt(numerator), fmt(denominator)
        if not num_str and not den_str:
            return "1"
        if not den_str:
            return num_str
        if not num_str:
            return f"1 / {den_str}"
        return f"{num_str} / {den_str}"

    def __eq__(self, other):
        return isinstance(other, ParsedUnit) and self._components == other._components

    def __hash__(self):
        return hash(tuple(self._components.items()))

    def __str__(self):
        return self.normalized()

    def __repr__(self):
        return f"ParsedUnit({self._components})"


class _UnitParser:
    """Recursive-descent parser (mirror of parser.rs ``UnitParser``)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    # expression := term (('/' | 'per') term)*
    def parse_expression(self) -> ParsedUnit:
        self._skip_ws()
        result = self.parse_term()
        while True:
            self._skip_ws()
            if self._peek() == "/":
                self.pos += 1
                self._skip_ws()
                result = result.divide(self.parse_term())
            elif self._check_keyword("per"):
                self._skip_keyword("per")
                self._skip_ws()
                result = result.divide(self.parse_term())
            else:
                break
        return result

    # term := factor (('*' | '·' | adjacency) factor)*
    def parse_term(self) -> ParsedUnit:
        result = self.parse_factor()
        while True:
            self._skip_ws()
            nxt = self._peek()
            if nxt in ("*", "·"):
                self.pos += 1
                self._skip_ws()
                result = result.multiply(self.parse_factor())
            elif (
                nxt is not None
                and nxt != "/"
                and not self._check_keyword("per")
                and self._is_unit_start(nxt)
            ):
                result = result.multiply(self.parse_factor())
            else:
                break
        return result

    # factor := '(' expression ')' exponent? | symbol exponent?
    def parse_factor(self) -> ParsedUnit:
        self._skip_ws()
        if self._peek() == "(":
            self.pos += 1
            inner = self.parse_expression()
            self._skip_ws()
            if self._peek() != ")":
                raise ParseError.parse_failed("missing closing parenthesis")
            self.pos += 1
            return inner.pow(self._parse_optional_exponent())
        symbol = self._parse_symbol()
        exp = self._parse_optional_exponent()
        return ParsedUnit({symbol: exp})

    def _parse_symbol(self) -> str:
        self._skip_ws()
        start = self.pos
        while (c := self._peek()) is not None and (c.isalnum() and c.isascii() or c == "_"):
            self.pos += 1
        if self.pos == start:
            raise ParseError.parse_failed("expected unit symbol")
        full_symbol = self.text[start : self.pos]

        # Handle trailing digits: "m2" == "m^2" unless "m2" is itself a unit
        # (parser.rs:291-308).
        last_letter_idx = None
        for i in range(len(full_symbol) - 1, -1, -1):
            if full_symbol[i].isalpha():
                last_letter_idx = i
                break
        if last_letter_idx is not None:
            base = full_symbol[: last_letter_idx + 1]
            trailing = full_symbol[last_letter_idx + 1 :]
            if trailing and trailing.isdigit():
                if UNIT_REGISTRY.lookup(full_symbol) is not None:
                    return full_symbol
                self.pos = start + last_letter_idx + 1
                return base
        return full_symbol

    def _parse_optional_exponent(self) -> int:
        self._skip_ws()
        has_marker = False
        if self._peek() == "^":
            self.pos += 1
            if self._peek() == "*":
                self.pos += 1
            has_marker = True
        elif self.text[self.pos :].startswith("**"):
            self.pos += 2
            has_marker = True
        self._skip_ws()
        c = self._peek()
        if c is not None and (c == "-" or c.isdigit()):
            return self._parse_exponent()
        if has_marker:
            raise ParseError.parse_failed("expected exponent after ^")
        return 1

    def _parse_exponent(self) -> int:
        start = self.pos
        if self._peek() == "-":
            self.pos += 1
        while (c := self._peek()) is not None and c.isdigit():
            self.pos += 1
        exp_str = self.text[start : self.pos]
        if not exp_str or exp_str == "-":
            raise ParseError.invalid_exponent(exp_str)
        return int(exp_str)

    def _skip_ws(self):
        while (c := self._peek()) is not None and c.isspace():
            self.pos += 1

    def _peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else None

    def _check_keyword(self, kw: str) -> bool:
        rest = self.text[self.pos :]
        if not rest.startswith(kw):
            return False
        after = rest[len(kw) : len(kw) + 1]
        return after == "" or not (after.isalnum() or after == "_")

    def _skip_keyword(self, kw: str):
        self.pos += len(kw)

    @staticmethod
    def _is_unit_start(c: str) -> bool:
        return (c.isalpha() and c.isascii()) or c in ("_", "(")
