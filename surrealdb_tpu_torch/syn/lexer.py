"""SurrealQL lexer.

Role of the reference's byte-level lexer with compound tokens (reference:
core/src/syn/lexer/). Produces a flat token list; keywords are recognised
contextually by the parser (SurrealQL keywords are case-insensitive and may
appear as identifiers in most positions).
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional

from surrealdb_tpu_torch.err import ParseError


class Token(NamedTuple):
    kind: str  # IDENT NUMBER STRING DURATION DATETIME UUID BYTES PARAM OP REGEX EOF
    value: object
    pos: int


# Multi-char operators, longest first.
_OPERATORS = [
    "<|",  # knn open  <|k,ef|>
    "|>",
    "?:",
    "??",
    "==",
    "!=",
    "?=",
    "*=",
    "!~",
    "*~",
    "<=",
    ">=",
    "+=",
    "-=",
    "+?=",
    "->",
    "<->",
    "<-",
    "**",
    "..",
    "::",
    "⟨",
    "&&",
    "||",
    "≤",
    "≥",
    "×",
    "÷",
]
_SINGLE = set("+-*/%=<>!&|,.;:()[]{}@?~^$")

_NUM_RE = re.compile(
    r"(?:\d[\d_]*\.\d[\d_]*(?:[eE][+-]?\d+)?|\d[\d_]*[eE][+-]?\d+|\d[\d_]*)(f|dec)?"
)
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_DUR_UNIT_RE = re.compile(r"(ns|us|µs|ms|s|m|h|d|w|y)")
_WS_RE = re.compile(r"[ \t\r\n]+")


class Lexer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)
        self.tokens: List[Token] = []

    def error(self, msg: str, pos: Optional[int] = None) -> ParseError:
        p = self.pos if pos is None else pos
        line = self.text.count("\n", 0, p) + 1
        col = p - (self.text.rfind("\n", 0, p) + 1) + 1
        return ParseError(msg, p, line, col)

    def lex(self) -> List[Token]:
        while True:
            self._skip_ws_comments()
            if self.pos >= self.n:
                self.tokens.append(Token("EOF", None, self.pos))
                return self.tokens
            start = self.pos
            c = self.text[self.pos]
            if c.isdigit():
                self._lex_number_or_duration()
            elif c == '"' or c == "'":
                self.tokens.append(Token("STRING", self._lex_string(c), start))
            elif c in ("s", "r", "d", "u", "b") and self.pos + 1 < self.n and self.text[
                self.pos + 1
            ] in ("'", '"'):
                self._lex_prefixed_string(c)
            elif c.isalpha() or c == "_":
                m = _IDENT_RE.match(self.text, self.pos)
                self.pos = m.end()
                self.tokens.append(Token("IDENT", m.group(), start))
                if m.group() == "function":
                    # `function(<sql args>) { <js> }` — capture the raw JS
                    # body as one SCRIPT token (reference: syn lexes JS
                    # compound tokens for sql::Script)
                    self._maybe_lex_script()
            elif c == "`":
                # backtick-quoted identifier
                end = self.text.find("`", self.pos + 1)
                if end < 0:
                    raise self.error("unterminated ` identifier")
                self.tokens.append(Token("IDENT", self.text[self.pos + 1 : end], start))
                self.pos = end + 1
            elif c == "⟨":
                # scan with \⟩ escape support (escape_ident emits it)
                j = self.pos + 1
                out = []
                while j < self.n and self.text[j] != "⟩":
                    if self.text[j] == "\\" and j + 1 < self.n and self.text[j + 1] == "⟩":
                        out.append("⟩")
                        j += 2
                    else:
                        out.append(self.text[j])
                        j += 1
                if j >= self.n:
                    raise self.error("unterminated ⟨ identifier")
                self.tokens.append(Token("IDENT", "".join(out), start))
                self.pos = j + 1
            elif c == "$":
                m = _IDENT_RE.match(self.text, self.pos + 1)
                if m:
                    self.pos = m.end()
                    self.tokens.append(Token("PARAM", m.group(), start))
                else:
                    self.pos += 1
                    self.tokens.append(Token("OP", "$", start))
            else:
                self._lex_operator()
        # unreachable

    # ------------------------------------------------------------------ ws
    def _skip_ws_comments(self) -> None:
        while self.pos < self.n:
            m = _WS_RE.match(self.text, self.pos)
            if m:
                self.pos = m.end()
                continue
            if (
                self.text.startswith("--", self.pos)
                or self.text.startswith("//", self.pos)
                or self.text.startswith("#", self.pos)
            ):
                nl = self.text.find("\n", self.pos)
                self.pos = self.n if nl < 0 else nl + 1
                continue
            if self.text.startswith("/*", self.pos):
                end = self.text.find("*/", self.pos + 2)
                if end < 0:
                    raise self.error("unterminated block comment")
                self.pos = end + 2
                continue
            return

    # ------------------------------------------------------------------ script
    def _maybe_lex_script(self) -> None:
        """After an IDENT `function`: if the source reads `( args ) {`, lex
        the SurrealQL arg list via a sub-lexer and capture the JS block as
        one SCRIPT token; otherwise leave the stream untouched."""
        ws = _WS_RE.match(self.text, self.pos)
        p = ws.end() if ws else self.pos
        if p >= self.n or self.text[p] != "(":
            return
        depth, j = 0, p
        while j < self.n:
            ch = self.text[j]
            if ch in "\"'":
                j = self._skip_quoted(j)
                continue
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if j >= self.n:
            return
        ws2 = _WS_RE.match(self.text, j + 1)
        q = ws2.end() if ws2 else j + 1
        if q >= self.n or self.text[q] != "{":
            return
        self.tokens.append(Token("OP", "(", p))
        sub = Lexer(self.text[p + 1 : j])
        for t in sub.lex():
            if t.kind == "EOF":
                break
            self.tokens.append(Token(t.kind, t.value, p + 1 + t.pos))
        self.tokens.append(Token("OP", ")", j))
        end = self._scan_js_block(q)
        self.tokens.append(Token("SCRIPT", self.text[q + 1 : end], q))
        self.pos = end + 1

    def _skip_quoted(self, i: int) -> int:
        """Index just past a quoted SQL string starting at i."""
        quote = self.text[i]
        j = i + 1
        while j < self.n:
            if self.text[j] == "\\":
                j += 2
                continue
            if self.text[j] == quote:
                return j + 1
            j += 1
        raise self.error("unterminated string", i)

    def _scan_js_block(self, open_pos: int) -> int:
        """Index of the `}` matching the `{` at open_pos, respecting JS
        strings, template literals, and comments."""
        depth = 0
        j = open_pos
        while j < self.n:
            ch = self.text[j]
            if ch in "\"'":
                j = self._skip_quoted(j)
                continue
            if ch == "`":
                j += 1
                while j < self.n and self.text[j] != "`":
                    if self.text[j] == "\\":
                        j += 2
                        continue
                    # ${ expr } inside a template nests normal JS braces
                    if self.text.startswith("${", j):
                        d2 = 1
                        j += 2
                        while j < self.n and d2:
                            if self.text[j] == "{":
                                d2 += 1
                            elif self.text[j] == "}":
                                d2 -= 1
                            j += 1
                        continue
                    j += 1
                j += 1
                continue
            if self.text.startswith("//", j):
                nl = self.text.find("\n", j)
                j = self.n if nl < 0 else nl + 1
                continue
            if self.text.startswith("/*", j):
                e = self.text.find("*/", j + 2)
                if e < 0:
                    raise self.error("unterminated comment in script", j)
                j = e + 2
                continue
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    return j
            j += 1
        raise self.error("unterminated script block", open_pos)

    # ------------------------------------------------------------------ num
    def _lex_number_or_duration(self) -> None:
        start = self.pos
        m = _NUM_RE.match(self.text, self.pos)
        if not m:
            raise self.error("invalid number")
        raw = m.group().replace("_", "")
        self.pos = m.end()
        # duration? only if a PLAIN INTEGER part is followed directly by a
        # unit — float/scientific forms like `2e6y` are a number + ident run
        # (a flexible record id), never a duration
        um = _DUR_UNIT_RE.match(self.text, self.pos)
        if um and m.group(1) is None and raw.isdigit() and not (
            um.group() in ("s", "m", "h", "d", "w", "y")
            and self.pos + len(um.group()) < self.n
            and (self.text[self.pos + len(um.group())].isalnum() or self.text[self.pos + len(um.group())] == "_")
            and not self.text[self.pos + len(um.group())].isdigit()
        ):
            # accumulate number-unit pairs: 1h30m
            total_text = raw + um.group()
            self.pos += len(um.group())
            while self.pos < self.n and self.text[self.pos].isdigit():
                m2 = _NUM_RE.match(self.text, self.pos)
                u2 = (
                    m2
                    and m2.group().replace("_", "").isdigit()
                    and _DUR_UNIT_RE.match(self.text, m2.end())
                )
                if not (m2 and u2):
                    break
                total_text += m2.group().replace("_", "") + u2.group()
                self.pos = u2.end()
            from surrealdb_tpu_torch.sql.value import Duration

            self.tokens.append(Token("DURATION", Duration.parse(total_text), start))
            return
        suffix = m.group(1)
        if suffix == "dec":
            from decimal import Decimal

            self.tokens.append(Token("NUMBER", Decimal(raw[:-3]), start))
        elif suffix == "f":
            self.tokens.append(Token("NUMBER", float(raw[:-1]), start))
        elif "." in raw or "e" in raw or "E" in raw:
            self.tokens.append(Token("NUMBER", float(raw), start))
        else:
            self.tokens.append(Token("NUMBER", int(raw), start))

    # ------------------------------------------------------------------ str
    def _lex_string(self, quote: str, raw: bool = False) -> str:
        # assumes text[pos] == quote
        out = []
        i = self.pos + 1
        while i < self.n:
            c = self.text[i]
            if c == "\\":
                if i + 1 >= self.n:
                    raise self.error("unterminated string", self.pos)
                e = self.text[i + 1]
                if raw:
                    # raw strings: only the quote escape collapses
                    out.append(e if e == quote else "\\" + e)
                    i += 2
                    continue
                mapping = {
                    "n": "\n",
                    "t": "\t",
                    "r": "\r",
                    "\\": "\\",
                    "/": "/",
                    '"': '"',
                    "'": "'",
                    "b": "\b",
                    "f": "\f",
                    "0": "\0",
                }
                if e == "u":
                    if self.text[i + 2] == "{":
                        end = self.text.find("}", i + 3)
                        out.append(chr(int(self.text[i + 3 : end], 16)))
                        i = end + 1
                        continue
                    out.append(chr(int(self.text[i + 2 : i + 6], 16)))
                    i += 6
                    continue
                # unknown escapes keep the backslash verbatim
                out.append(mapping[e] if e in mapping else "\\" + e)
                i += 2
                continue
            if c == quote:
                self.pos = i + 1
                return "".join(out)
            out.append(c)
            i += 1
        raise self.error("unterminated string", self.pos)

    def _lex_prefixed_string(self, prefix: str) -> None:
        start = self.pos
        self.pos += 1  # skip prefix char
        body = self._lex_string(self.text[self.pos], raw=(prefix == "r"))
        if prefix == "s":
            self.tokens.append(Token("STRING", body, start))
        elif prefix == "r":
            self.tokens.append(Token("STRING", body, start))
        elif prefix == "d":
            from surrealdb_tpu_torch.sql.value import Datetime

            try:
                self.tokens.append(Token("DATETIME", Datetime.parse(body), start))
            except ValueError as e:
                raise self.error(f"invalid datetime: {e}", start)
        elif prefix == "u":
            import uuid as _uuid

            from surrealdb_tpu_torch.sql.value import Uuid

            try:
                self.tokens.append(Token("UUID", Uuid(_uuid.UUID(body)), start))
            except ValueError as e:
                raise self.error(f"invalid uuid: {e}", start)
        elif prefix == "b":
            try:
                self.tokens.append(Token("BYTES", bytes.fromhex(body), start))
            except ValueError as e:
                raise self.error(f"invalid bytes literal: {e}", start)

    # ------------------------------------------------------------------ ops
    def _lex_operator(self) -> None:
        start = self.pos
        for op in _OPERATORS:
            if self.text.startswith(op, self.pos):
                self.pos += len(op)
                self.tokens.append(Token("OP", op, start))
                return
        c = self.text[self.pos]
        if c in _SINGLE:
            self.pos += 1
            self.tokens.append(Token("OP", c, start))
            return
        raise self.error(f"unexpected character {c!r}")


def lex(text: str) -> List[Token]:
    return Lexer(text).lex()
