"""Minimal embedded JavaScript interpreter (ES5-ish subset + arrows).

Role of the reference's QuickJS binding (reference: core/src/fnc/script/
main.rs — `function() { … }` blocks run against the current document with
memory/stack limits). No JS engine ships in this environment, so the
framework embeds its own tree-walking interpreter: tokenizer → Pratt parser
→ evaluator with closures, `this`, arrow functions, try/catch, and the
standard-library surface scripts actually use (Math, JSON, Object, Array &
string/array/number methods).

Resource limits (reference cnf SCRIPTING_MAX_* core/src/cnf/mod.rs:56-61):
an operation budget decremented on every evaluated node and a call-depth
cap — both raise ScriptLimitError, surfaced as a query error.
"""

from __future__ import annotations

import json as _json
import math as _math
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple


class ScriptError(Exception):
    """JS runtime error (TypeError, thrown values, ...)."""

    def __init__(self, msg: str, value: Any = None):
        super().__init__(msg)
        self.value = value if value is not None else msg


class ScriptLimitError(ScriptError):
    """Operation budget or stack depth exhausted."""


class JSUndefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


undefined = JSUndefined()


# ---------------------------------------------------------------- tokenizer
_PUNCT = [
    "...", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=", "??=",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "**", "<<", ">>", "&=", "|=", "^=",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/",
    "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
]
_KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "for", "while",
    "do", "break", "continue", "new", "typeof", "instanceof", "in", "of",
    "true", "false", "null", "undefined", "this", "throw", "try", "catch",
    "finally", "switch", "case", "default", "delete", "void",
}


class _Tok:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind  # num str ident kw punct template eof
        self.value = value
        self.pos = pos


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise ScriptError("unterminated comment")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(_Tok("num", float(int(src[i:j], 16)), i))
                i = j
                continue
            while j < n and (src[j].isdigit() or src[j] in ".eE" or (src[j] in "+-" and src[j - 1] in "eE")):
                j += 1
            try:
                num = float(src[i:j])
            except ValueError:
                raise ScriptError(f"invalid number literal at {i}")
            toks.append(_Tok("num", num, i))
            i = j
            continue
        if c in "'\"":
            j = i + 1
            out = []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    out.append(_unescape(src[j + 1]))
                    j += 2
                else:
                    out.append(src[j])
                    j += 1
            if j >= n:
                raise ScriptError("unterminated string")
            toks.append(_Tok("str", "".join(out), i))
            i = j + 1
            continue
        if c == "`":
            # template literal -> token ("template", [parts]) where parts are
            # ("str", s) or ("expr", tokenized-subexpression-source)
            parts: List[Tuple[str, Any]] = []
            j = i + 1
            buf = []
            while j < n and src[j] != "`":
                if src[j] == "\\":
                    buf.append(_unescape(src[j + 1]))
                    j += 2
                elif src.startswith("${", j):
                    parts.append(("str", "".join(buf)))
                    buf = []
                    depth = 1
                    k = j + 2
                    while k < n and depth:
                        if src[k] == "{":
                            depth += 1
                        elif src[k] == "}":
                            depth -= 1
                        k += 1
                    parts.append(("expr", src[j + 2 : k - 1]))
                    j = k
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise ScriptError("unterminated template literal")
            parts.append(("str", "".join(buf)))
            toks.append(_Tok("template", parts, i))
            i = j + 1
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            word = src[i:j]
            toks.append(_Tok("kw" if word in _KEYWORDS else "ident", word, i))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(_Tok("punct", p, i))
                i += len(p)
                break
        else:
            raise ScriptError(f"unexpected character {c!r} in script")
    toks.append(_Tok("eof", None, n))
    return toks


def _unescape(c: str) -> str:
    return {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "0": "\0"}.get(c, c)


# ---------------------------------------------------------------- parser
# AST nodes are plain tuples: (kind, ...) — compact and fast to evaluate.

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "**=", "&&=", "||=", "??="}


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, off=0) -> _Tok:
        return self.toks[min(self.i + off, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def is_p(self, v, off=0) -> bool:
        t = self.peek(off)
        return t.kind == "punct" and t.value == v

    def eat_p(self, v) -> bool:
        if self.is_p(v):
            self.next()
            return True
        return False

    def expect_p(self, v) -> None:
        if not self.eat_p(v):
            raise ScriptError(f"expected {v!r} in script (got {self.peek().value!r})")

    def is_kw(self, v, off=0) -> bool:
        t = self.peek(off)
        return t.kind == "kw" and t.value == v

    def eat_kw(self, v) -> bool:
        if self.is_kw(v):
            self.next()
            return True
        return False

    # -------------------------------------------------------- statements
    def parse_program(self) -> tuple:
        body = []
        while self.peek().kind != "eof":
            body.append(self.statement())
        return ("block", body)

    def statement(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.value == "{":
            self.next()
            body = []
            while not self.eat_p("}"):
                body.append(self.statement())
            return ("block", body)
        if t.kind == "punct" and t.value == ";":
            self.next()
            return ("empty",)
        if t.kind == "kw":
            kw = t.value
            if kw in ("var", "let", "const"):
                self.next()
                decls = []
                while True:
                    name = self.next().value
                    init = None
                    if self.eat_p("="):
                        init = self.assignment()
                    decls.append((name, init))
                    if not self.eat_p(","):
                        break
                self.eat_p(";")
                return ("decl", decls)
            if kw == "function" and self.peek(1).kind == "ident":
                self.next()
                name = self.next().value
                fn = self._function_rest(name)
                return ("decl", [(name, fn)])
            if kw == "if":
                self.next()
                self.expect_p("(")
                cond = self.expression()
                self.expect_p(")")
                then = self.statement()
                other = self.statement() if self.eat_kw("else") else None
                return ("if", cond, then, other)
            if kw == "while":
                self.next()
                self.expect_p("(")
                cond = self.expression()
                self.expect_p(")")
                return ("while", cond, self.statement())
            if kw == "do":
                self.next()
                body = self.statement()
                if not self.eat_kw("while"):
                    raise ScriptError("expected while after do body")
                self.expect_p("(")
                cond = self.expression()
                self.expect_p(")")
                self.eat_p(";")
                return ("dowhile", cond, body)
            if kw == "for":
                return self._for()
            if kw == "return":
                self.next()
                val = None
                if not (self.is_p(";") or self.is_p("}") or self.peek().kind == "eof"):
                    val = self.expression()
                self.eat_p(";")
                return ("return", val)
            if kw == "break":
                self.next()
                self.eat_p(";")
                return ("break",)
            if kw == "continue":
                self.next()
                self.eat_p(";")
                return ("continue",)
            if kw == "throw":
                self.next()
                v = self.expression()
                self.eat_p(";")
                return ("throw", v)
            if kw == "try":
                self.next()
                block = self.statement()
                catch_name = catch_body = final = None
                if self.eat_kw("catch"):
                    if self.eat_p("("):
                        catch_name = self.next().value
                        self.expect_p(")")
                    catch_body = self.statement()
                if self.eat_kw("finally"):
                    final = self.statement()
                return ("try", block, catch_name, catch_body, final)
            if kw == "switch":
                self.next()
                self.expect_p("(")
                disc = self.expression()
                self.expect_p(")")
                self.expect_p("{")
                cases = []  # (test|None, [stmts])
                while not self.eat_p("}"):
                    if self.eat_kw("case"):
                        test = self.expression()
                    else:
                        if not self.eat_kw("default"):
                            raise ScriptError("expected case/default")
                        test = None
                    self.expect_p(":")
                    stmts = []
                    while not (
                        self.is_kw("case") or self.is_kw("default") or self.is_p("}")
                    ):
                        stmts.append(self.statement())
                    cases.append((test, stmts))
                return ("switch", disc, cases)
        expr = self.expression()
        self.eat_p(";")
        return ("expr", expr)

    def _for(self) -> tuple:
        self.next()  # for
        self.expect_p("(")
        # for (let x of/in e) | for (init; cond; step)
        if self.is_kw("var") or self.is_kw("let") or self.is_kw("const"):
            save = self.i
            self.next()
            name = self.next().value
            if self.is_kw("of") or self.is_kw("in"):
                kind = self.next().value
                it = self.expression()
                self.expect_p(")")
                return ("for" + kind, name, it, self.statement())
            self.i = save
        init = None
        if not self.is_p(";"):
            if self.is_kw("var") or self.is_kw("let") or self.is_kw("const"):
                init = self.statement()  # consumes the ';'
            else:
                init = ("expr", self.expression())
                self.expect_p(";")
        else:
            self.next()
        cond = None if self.is_p(";") else self.expression()
        self.expect_p(";")
        step = None if self.is_p(")") else self.expression()
        self.expect_p(")")
        return ("for", init, cond, step, self.statement())

    def _function_rest(self, name: Optional[str]) -> tuple:
        self.expect_p("(")
        params = []
        rest = None
        while not self.eat_p(")"):
            if self.eat_p("..."):
                rest = self.next().value
            else:
                params.append(self.next().value)
            if not self.eat_p(","):
                if not self.is_p(")"):
                    raise ScriptError("bad parameter list")
        body = self.statement()  # block
        return ("function", name, params, rest, body, False)

    # -------------------------------------------------------- expressions
    def expression(self) -> tuple:
        e = self.assignment()
        while self.eat_p(","):
            e = ("seq", e, self.assignment())
        return e

    def assignment(self) -> tuple:
        # arrow lookahead: ident => ... or ( params ) => ...
        t = self.peek()
        if t.kind == "ident" and self.is_p("=>", 1):
            self.next()
            self.next()
            return self._arrow_body([t.value], None)
        if t.kind == "punct" and t.value == "(":
            j = self._match_paren(self.i)
            if j is not None and self.toks[j + 1].kind == "punct" and self.toks[j + 1].value == "=>":
                self.next()
                params, rest = [], None
                while not self.eat_p(")"):
                    if self.eat_p("..."):
                        rest = self.next().value
                    else:
                        params.append(self.next().value)
                    self.eat_p(",")
                self.expect_p("=>")
                return self._arrow_body(params, rest)
        left = self.ternary()
        t = self.peek()
        if t.kind == "punct" and t.value in _ASSIGN_OPS:
            self.next()
            right = self.assignment()
            if left[0] not in ("name", "member", "index"):
                raise ScriptError("invalid assignment target")
            return ("assign", t.value, left, right)
        return left

    def _arrow_body(self, params, rest) -> tuple:
        if self.is_p("{"):
            body = self.statement()
        else:
            body = ("return", self.assignment())
        return ("function", None, params, rest, body, True)

    def _match_paren(self, start: int) -> Optional[int]:
        depth = 0
        for j in range(start, len(self.toks)):
            t = self.toks[j]
            if t.kind == "punct":
                if t.value in ("(", "[", "{"):
                    depth += 1
                elif t.value in (")", "]", "}"):
                    depth -= 1
                    if depth == 0:
                        return j
        return None

    def ternary(self) -> tuple:
        cond = self.binary(0)
        if self.eat_p("?"):
            a = self.assignment()
            self.expect_p(":")
            b = self.assignment()
            return ("cond", cond, a, b)
        return cond

    _BINOPS = [
        ("??",), ("||",), ("&&",), ("|",), ("^",), ("&",),
        ("==", "!=", "===", "!=="),
        ("<", ">", "<=", ">=", "instanceof", "in"),
        ("<<", ">>", ">>>"), ("+", "-"), ("*", "/", "%"),
    ]

    def binary(self, level: int) -> tuple:
        if level >= len(self._BINOPS):
            return self.exponent()
        ops = self._BINOPS[level]
        left = self.binary(level + 1)
        while True:
            t = self.peek()
            val = t.value
            if (t.kind == "punct" or t.kind == "kw") and val in ops:
                # `in`/`instanceof` only as keywords
                self.next()
                right = self.binary(level + 1)
                left = ("bin", val, left, right)
            else:
                return left

    def exponent(self) -> tuple:
        base = self.unary()
        if self.eat_p("**"):
            return ("bin", "**", base, self.exponent())
        return base

    def unary(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "~", "+", "-", "++", "--"):
            self.next()
            if t.value in ("++", "--"):
                tgt = self.unary()
                return ("update", t.value, tgt, True)
            return ("unary", t.value, self.unary())
        if t.kind == "kw" and t.value in ("typeof", "void", "delete"):
            self.next()
            return ("unary", t.value, self.unary())
        return self.postfix()

    def postfix(self) -> tuple:
        e = self.callmember()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("update", t.value, e, False)
        return e

    def callmember(self) -> tuple:
        if self.eat_kw("new"):
            callee = self.callmember()
            if callee[0] == "call":
                return ("new", callee[1], callee[2])
            return ("new", callee, [])
        e = self.primary()
        while True:
            if self.eat_p("."):
                name = self.next().value
                e = ("member", e, name)
            elif self.eat_p("["):
                idx = self.expression()
                self.expect_p("]")
                e = ("index", e, idx)
            elif self.is_p("("):
                self.next()
                args = []
                while not self.eat_p(")"):
                    if self.eat_p("..."):
                        args.append(("spread", self.assignment()))
                    else:
                        args.append(self.assignment())
                    self.eat_p(",")
                e = ("call", e, args)
            else:
                return e

    def primary(self) -> tuple:
        t = self.next()
        if t.kind == "num":
            return ("lit", t.value)
        if t.kind == "str":
            return ("lit", t.value)
        if t.kind == "template":
            parts = []
            for kind, v in t.value:
                if kind == "str":
                    parts.append(("lit", v))
                else:
                    sub = _Parser(_tokenize(v))
                    parts.append(sub.expression())
            return ("template", parts)
        if t.kind == "ident":
            return ("name", t.value)
        if t.kind == "kw":
            if t.value == "true":
                return ("lit", True)
            if t.value == "false":
                return ("lit", False)
            if t.value == "null":
                return ("lit", None)
            if t.value == "undefined":
                return ("lit", undefined)
            if t.value == "this":
                return ("this",)
            if t.value == "function":
                return self._function_rest(None)
            raise ScriptError(f"unexpected keyword {t.value!r}")
        if t.kind == "punct":
            if t.value == "(":
                e = self.expression()
                self.expect_p(")")
                return e
            if t.value == "[":
                items = []
                while not self.eat_p("]"):
                    if self.eat_p("..."):
                        items.append(("spread", self.assignment()))
                    else:
                        items.append(self.assignment())
                    self.eat_p(",")
                return ("array", items)
            if t.value == "{":
                props = []
                while not self.eat_p("}"):
                    kt = self.next()
                    if kt.kind in ("ident", "kw", "str"):
                        key = kt.value
                    elif kt.kind == "num":
                        key = _num_to_str(kt.value)
                    else:
                        raise ScriptError("bad object key")
                    if self.is_p("("):  # method shorthand
                        fn = self._function_rest(key)
                        props.append((key, fn))
                    elif self.eat_p(":"):
                        props.append((key, self.assignment()))
                    else:  # shorthand {a}
                        props.append((key, ("name", key)))
                    self.eat_p(",")
                return ("object", props)
        raise ScriptError(f"unexpected token {t.value!r} in script")


# ---------------------------------------------------------------- runtime
class JSFunction:
    __slots__ = ("name", "params", "rest", "body", "env", "is_arrow", "this")

    def __init__(self, name, params, rest, body, env, is_arrow, this=undefined):
        self.name = name or ""
        self.params = params
        self.rest = rest
        self.body = body
        self.env = env
        self.is_arrow = is_arrow
        self.this = this  # captured lexical this for arrows


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def get(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        raise ScriptError(f"{name} is not defined")

    def set(self, name, value):
        e = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = value
                return
            e = e.parent
        # implicit global (matches sloppy-mode JS)
        self.vars[name] = value

    def declare(self, name, value):
        self.vars[name] = value


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Thrown(Exception):
    def __init__(self, value):
        self.value = value


def _num_to_str(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    if float(v).is_integer() and abs(v) < 1e21:
        return str(int(v))
    return repr(float(v))


def js_string(v: Any) -> str:
    if v is undefined:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _num_to_str(float(v))
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ",".join("" if x is undefined or x is None else js_string(x) for x in v)
    if isinstance(v, dict):
        return "[object Object]"
    if isinstance(v, JSFunction):
        return f"function {v.name}() {{ ... }}"
    return str(v)


def js_number(v: Any) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if v is None:
        return 0.0
    if v is undefined:
        return float("nan")
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            if s.startswith(("0x", "0X")):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return float("nan")
    if isinstance(v, list):
        if not v:
            return 0.0
        if len(v) == 1:
            return js_number(v[0])
    return float("nan")


def js_truthy(v: Any) -> bool:
    if v is undefined or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v == v and v != 0
    if isinstance(v, str):
        return len(v) > 0
    return True


def _strict_eq(a, b) -> bool:
    if a is undefined or b is undefined:
        return a is b
    if a is None or b is None:
        return a is b
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def _loose_eq(a, b) -> bool:
    if (a is None or a is undefined) and (b is None or b is undefined):
        return True
    if a is None or a is undefined or b is None or b is undefined:
        return False
    if isinstance(a, str) and isinstance(b, (int, float)) and not isinstance(b, bool):
        return js_number(a) == b
    if isinstance(b, str) and isinstance(a, (int, float)) and not isinstance(a, bool):
        return js_number(b) == a
    if isinstance(a, bool):
        return _loose_eq(js_number(a), b)
    if isinstance(b, bool):
        return _loose_eq(a, js_number(b))
    return _strict_eq(a, b)


class Interpreter:
    def __init__(self, max_ops: int = 2_000_000, max_depth: int = 128):
        self.budget = max_ops
        self.max_depth = max_depth
        self.depth = 0
        self.console: List[str] = []

    # ------------------------------------------------------------ entry
    def run(self, src: str, this: Any = undefined, args: Optional[List[Any]] = None):
        """Execute a script body the way the reference wraps it (main.rs:69):
        as a function called with `this` = current doc and `arguments` =
        computed call args. Returns the script's return value."""
        program = _Parser(_tokenize(src)).parse_program()
        env = _Env(_globals_env())
        env.declare("arguments", list(args or []))
        try:
            self.exec_block(program, env, this)
        except _Return as r:
            return r.value
        except _Thrown as t:
            raise ScriptError(js_string(_err_message(t.value)), t.value) from None
        return undefined

    # ------------------------------------------------------------ stmts
    def exec_block(self, node, env, this):
        for stmt in node[1]:
            self.exec_stmt(stmt, env, this)

    def exec_stmt(self, node, env, this):
        self._tick()
        kind = node[0]
        if kind == "expr":
            self.eval(node[1], env, this)
        elif kind == "decl":
            for name, init in node[1]:
                env.declare(name, self.eval(init, env, this) if init is not None else undefined)
        elif kind == "block":
            inner = _Env(env)
            for stmt in node[1]:
                self.exec_stmt(stmt, inner, this)
        elif kind == "if":
            if js_truthy(self.eval(node[1], env, this)):
                self.exec_stmt(node[2], env, this)
            elif node[3] is not None:
                self.exec_stmt(node[3], env, this)
        elif kind == "while":
            while js_truthy(self.eval(node[1], env, this)):
                self._tick()
                try:
                    self.exec_stmt(node[2], env, this)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "dowhile":
            while True:
                self._tick()
                try:
                    self.exec_stmt(node[2], env, this)
                except _Break:
                    break
                except _Continue:
                    pass
                if not js_truthy(self.eval(node[1], env, this)):
                    break
        elif kind == "for":
            _, init, cond, step, body = node
            loop_env = _Env(env)
            if init is not None:
                self.exec_stmt(init, loop_env, this)
            while cond is None or js_truthy(self.eval(cond, loop_env, this)):
                self._tick()
                try:
                    self.exec_stmt(body, loop_env, this)
                except _Break:
                    break
                except _Continue:
                    pass
                if step is not None:
                    self.eval(step, loop_env, this)
        elif kind == "forof":
            _, name, it_expr, body = node
            seq = self.eval(it_expr, env, this)
            if isinstance(seq, dict):
                raise ScriptError("object is not iterable (use for..in)")
            if isinstance(seq, str):
                seq = list(seq)
            for item in list(seq if isinstance(seq, list) else []):
                self._tick()
                loop_env = _Env(env)
                loop_env.declare(name, item)
                try:
                    self.exec_stmt(body, loop_env, this)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "forin":
            _, name, it_expr, body = node
            obj = self.eval(it_expr, env, this)
            if isinstance(obj, dict):
                ks = list(obj.keys())
            elif isinstance(obj, list):
                ks = [str(i) for i in range(len(obj))]
            else:
                ks = []
            for k in ks:
                self._tick()
                loop_env = _Env(env)
                loop_env.declare(name, k)
                try:
                    self.exec_stmt(body, loop_env, this)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "return":
            raise _Return(self.eval(node[1], env, this) if node[1] is not None else undefined)
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "throw":
            raise _Thrown(self.eval(node[1], env, this))
        elif kind == "try":
            _, block, catch_name, catch_body, final = node
            try:
                self.exec_stmt(block, env, this)
            except _Thrown as t:
                if catch_body is not None:
                    cenv = _Env(env)
                    if catch_name:
                        cenv.declare(catch_name, t.value)
                    self.exec_stmt(catch_body, cenv, this)
                elif final is None:
                    raise
            except ScriptLimitError:
                raise  # resource limits are not catchable in-script
            except ScriptError as e:
                if catch_body is not None:
                    cenv = _Env(env)
                    if catch_name:
                        cenv.declare(catch_name, _make_error(str(e)))
                    self.exec_stmt(catch_body, cenv, this)
                elif final is None:
                    raise
            finally:
                if final is not None:
                    self.exec_stmt(final, env, this)
        elif kind == "switch":
            _, disc_e, cases = node
            disc = self.eval(disc_e, env, this)
            matched = False
            try:
                for test, stmts in cases:
                    if not matched:
                        if test is None:
                            matched = True
                        elif _strict_eq(self.eval(test, env, this), disc):
                            matched = True
                    if matched:
                        for s in stmts:
                            self.exec_stmt(s, env, this)
            except _Break:
                pass
        elif kind == "empty":
            pass
        else:
            raise ScriptError(f"unknown statement {kind}")

    # ------------------------------------------------------------ exprs
    def eval(self, node, env, this):
        self._tick()
        kind = node[0]
        if kind == "lit":
            return node[1]
        if kind == "name":
            return env.get(node[1])
        if kind == "this":
            return this
        if kind == "template":
            return "".join(js_string(self.eval(p, env, this)) for p in node[1])
        if kind == "array":
            out = []
            for item in node[1]:
                if item[0] == "spread":
                    v = self.eval(item[1], env, this)
                    out.extend(v if isinstance(v, list) else [v])
                else:
                    out.append(self.eval(item, env, this))
            return out
        if kind == "object":
            return {k: self.eval(v, env, this) for k, v in node[1]}
        if kind == "function":
            _, name, params, rest, body, is_arrow = node
            return JSFunction(name, params, rest, body, env, is_arrow, this if is_arrow else undefined)
        if kind == "seq":
            self.eval(node[1], env, this)
            return self.eval(node[2], env, this)
        if kind == "cond":
            return (
                self.eval(node[2], env, this)
                if js_truthy(self.eval(node[1], env, this))
                else self.eval(node[3], env, this)
            )
        if kind == "bin":
            return self._binop(node, env, this)
        if kind == "unary":
            return self._unary(node, env, this)
        if kind == "update":
            _, op, target, prefix = node
            old = js_number(self.eval(target, env, this))
            new = old + (1 if op == "++" else -1)
            self._store(target, new, env, this)
            return new if prefix else old
        if kind == "assign":
            _, op, target, value_e = node
            if op == "=":
                v = self.eval(value_e, env, this)
            else:
                cur = self.eval(target, env, this)
                if op == "&&=":
                    if not js_truthy(cur):
                        return cur
                    v = self.eval(value_e, env, this)
                elif op == "||=":
                    if js_truthy(cur):
                        return cur
                    v = self.eval(value_e, env, this)
                elif op == "??=":
                    if cur is not undefined and cur is not None:
                        return cur
                    v = self.eval(value_e, env, this)
                else:
                    v = self._arith(op[:-1], cur, self.eval(value_e, env, this))
            self._store(target, v, env, this)
            return v
        if kind == "member":
            obj = self.eval(node[1], env, this)
            return self._member(obj, node[2])
        if kind == "index":
            obj = self.eval(node[1], env, this)
            idx = self.eval(node[2], env, this)
            return self._index(obj, idx)
        if kind == "call":
            return self._call(node, env, this)
        if kind == "new":
            return self._new(node, env, this)
        if kind == "spread":
            raise ScriptError("unexpected spread")
        raise ScriptError(f"unknown expression {kind}")

    # ------------------------------------------------------------ helpers
    def _tick(self):
        self.budget -= 1
        if self.budget <= 0:
            raise ScriptLimitError("script operation limit exceeded")

    def _store(self, target, value, env, this):
        kind = target[0]
        if kind == "name":
            env.set(target[1], value)
        elif kind == "member":
            obj = self.eval(target[1], env, this)
            self._set_member(obj, target[2], value)
        elif kind == "index":
            obj = self.eval(target[1], env, this)
            idx = self.eval(target[2], env, this)
            if isinstance(obj, list):
                i = int(js_number(idx))
                while len(obj) <= i:
                    obj.append(undefined)
                obj[i] = value
            elif isinstance(obj, dict):
                obj[js_string(idx)] = value
            else:
                raise ScriptError("cannot assign into this value")
        else:
            raise ScriptError("invalid assignment target")

    def _set_member(self, obj, name, value):
        if isinstance(obj, dict):
            obj[name] = value
        elif isinstance(obj, list) and name == "length":
            n = int(js_number(value))
            del obj[n:]
        else:
            raise ScriptError(f"cannot set property {name!r}")

    def _binop(self, node, env, this):
        _, op, le, re_ = node
        if op == "&&":
            l = self.eval(le, env, this)
            return self.eval(re_, env, this) if js_truthy(l) else l
        if op == "||":
            l = self.eval(le, env, this)
            return l if js_truthy(l) else self.eval(re_, env, this)
        if op == "??":
            l = self.eval(le, env, this)
            return self.eval(re_, env, this) if l is undefined or l is None else l
        l = self.eval(le, env, this)
        r = self.eval(re_, env, this)
        if op == "===":
            return _strict_eq(l, r)
        if op == "!==":
            return not _strict_eq(l, r)
        if op == "==":
            return _loose_eq(l, r)
        if op == "!=":
            return not _loose_eq(l, r)
        if op in ("<", ">", "<=", ">="):
            if isinstance(l, str) and isinstance(r, str):
                return {"<": l < r, ">": l > r, "<=": l <= r, ">=": l >= r}[op]
            ln, rn = js_number(l), js_number(r)
            if ln != ln or rn != rn:
                return False
            return {"<": ln < rn, ">": ln > rn, "<=": ln <= rn, ">=": ln >= rn}[op]
        if op == "in":
            if isinstance(r, dict):
                return js_string(l) in r
            if isinstance(r, list):
                i = js_number(l)
                return i.is_integer() and 0 <= i < len(r)
            raise ScriptError("'in' expects an object")
        if op == "instanceof":
            return isinstance(l, dict) and l.get("__class__") == getattr(r, "name", r)
        return self._arith(op, l, r)

    def _arith(self, op, l, r):
        if op == "+":
            if isinstance(l, str) or isinstance(r, str) or isinstance(l, (list, dict)) or isinstance(r, (list, dict)):
                return js_string(l) + js_string(r)
            return js_number(l) + js_number(r)
        ln, rn = js_number(l), js_number(r)
        if op == "-":
            return ln - rn
        if op == "*":
            return ln * rn
        if op == "/":
            if rn == 0:
                if ln == 0 or ln != ln:
                    return float("nan")
                return float("inf") if (ln > 0) == (rn >= 0 and not _neg_zero(rn)) else float("-inf")
            return ln / rn
        if op == "%":
            if rn == 0 or ln != ln or rn != rn:
                return float("nan")
            return _math.fmod(ln, rn)
        if op == "**":
            try:
                return float(ln**rn)
            except (OverflowError, ValueError):
                return float("nan")
        # bitwise on int32
        li, ri = _to_int32(ln), _to_int32(rn)
        if op == "&":
            return float(_to_int32(float(li & ri)))
        if op == "|":
            return float(_to_int32(float(li | ri)))
        if op == "^":
            return float(_to_int32(float(li ^ ri)))
        if op == "<<":
            return float(_to_int32(float(li << (ri & 31))))
        if op == ">>":
            return float(li >> (ri & 31))
        if op == ">>>":
            return float((li & 0xFFFFFFFF) >> (ri & 31))
        raise ScriptError(f"unknown operator {op}")

    def _unary(self, node, env, this):
        _, op, operand = node
        if op == "typeof":
            try:
                v = self.eval(operand, env, this)
            except ScriptError:
                return "undefined"
            if v is undefined:
                return "undefined"
            if v is None:
                return "object"
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, JSFunction) or callable(v):
                return "function"
            return "object"
        if op == "delete":
            if operand[0] == "member":
                obj = self.eval(operand[1], env, this)
                if isinstance(obj, dict):
                    obj.pop(operand[2], None)
                return True
            if operand[0] == "index":
                obj = self.eval(operand[1], env, this)
                idx = self.eval(operand[2], env, this)
                if isinstance(obj, dict):
                    obj.pop(js_string(idx), None)
                elif isinstance(obj, list):
                    i = int(js_number(idx))
                    if 0 <= i < len(obj):
                        obj[i] = undefined
                return True
            return True
        v = self.eval(operand, env, this)
        if op == "!":
            return not js_truthy(v)
        if op == "-":
            return -js_number(v)
        if op == "+":
            return js_number(v)
        if op == "~":
            return float(~_to_int32(js_number(v)))
        if op == "void":
            return undefined
        raise ScriptError(f"unknown unary {op}")

    def _member(self, obj, name):
        if obj is undefined or obj is None:
            raise ScriptError(f"cannot read property {name!r} of {js_string(obj)}")
        if isinstance(obj, dict):
            if name in obj:
                return obj[name]
            from .stdlib import object_method

            m = object_method(self, obj, name)
            return m if m is not None else undefined
        if isinstance(obj, list):
            if name == "length":
                return float(len(obj))
            from .stdlib import array_method

            m = array_method(self, obj, name)
            if m is None:
                raise ScriptError(f"array has no method {name!r}")
            return m
        if isinstance(obj, str):
            if name == "length":
                return float(len(obj))
            from .stdlib import string_method

            m = string_method(self, obj, name)
            if m is None:
                raise ScriptError(f"string has no method {name!r}")
            return m
        if isinstance(obj, (int, float)):
            from .stdlib import number_method

            m = number_method(self, float(obj), name)
            if m is None:
                raise ScriptError(f"number has no method {name!r}")
            return m
        if isinstance(obj, JSFunction) and name == "name":
            return obj.name
        if callable(obj):
            sub = getattr(obj, "js_members", None)
            if sub and name in sub:
                return sub[name]
        raise ScriptError(f"cannot read property {name!r}")

    def _index(self, obj, idx):
        if isinstance(obj, list):
            if isinstance(idx, (int, float)) and not isinstance(idx, bool):
                i = int(idx)
                if 0 <= i < len(obj):
                    return obj[i]
                return undefined
            return self._member(obj, js_string(idx))
        if isinstance(obj, str):
            if isinstance(idx, (int, float)) and not isinstance(idx, bool):
                i = int(idx)
                return obj[i] if 0 <= i < len(obj) else undefined
            return self._member(obj, js_string(idx))
        if isinstance(obj, dict):
            k = js_string(idx)
            return obj.get(k, undefined)
        return self._member(obj, js_string(idx))

    def _call(self, node, env, this):
        _, callee, arg_nodes = node
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                v = self.eval(a[1], env, this)
                args.extend(v if isinstance(v, list) else [v])
            else:
                args.append(self.eval(a, env, this))
        if callee[0] == "member":
            obj = self.eval(callee[1], env, this)
            fn = self._member(obj, callee[2])
            return self.call_function(fn, args, this_val=obj)
        if callee[0] == "index":
            obj = self.eval(callee[1], env, this)
            fn = self._index(obj, self.eval(callee[2], env, this))
            return self.call_function(fn, args, this_val=obj)
        fn = self.eval(callee, env, this)
        return self.call_function(fn, args, this_val=undefined)

    def _new(self, node, env, this):
        _, callee_node, arg_nodes = node
        args = [self.eval(a, env, this) for a in arg_nodes]
        callee = self.eval(callee_node, env, this)
        ctor = getattr(callee, "js_construct", None)
        if ctor is not None:
            return ctor(self, args)
        if isinstance(callee, JSFunction):
            obj: Dict[str, Any] = {}
            self.call_function(callee, args, this_val=obj)
            return obj
        raise ScriptError("value is not a constructor")

    def call_function(self, fn, args: List[Any], this_val=undefined):
        if isinstance(fn, JSFunction):
            if self.depth >= self.max_depth:
                raise ScriptLimitError("script stack depth exceeded")
            env = _Env(fn.env)
            for i, p in enumerate(fn.params):
                env.declare(p, args[i] if i < len(args) else undefined)
            if fn.rest is not None:
                env.declare(fn.rest, list(args[len(fn.params) :]))
            env.declare("arguments", list(args))
            bound_this = fn.this if fn.is_arrow else this_val
            self.depth += 1
            try:
                self.exec_stmt(fn.body, env, bound_this)
            except _Return as r:
                return r.value
            finally:
                self.depth -= 1
            return undefined
        if callable(fn):
            return fn(self, this_val, args)
        raise ScriptError(f"{js_string(fn)} is not a function")


def _neg_zero(x: float) -> bool:
    return x == 0 and _math.copysign(1.0, x) < 0


def _to_int32(x: float) -> int:
    if x != x or x in (float("inf"), float("-inf")):
        return 0
    i = int(x) & 0xFFFFFFFF
    return i - 0x100000000 if i >= 0x80000000 else i


def _make_error(msg: str, cls: str = "Error") -> dict:
    return {"name": cls, "message": msg, "__class__": cls}


def _err_message(v) -> str:
    if isinstance(v, dict) and "message" in v:
        return f"{v.get('name', 'Error')}: {js_string(v['message'])}"
    return js_string(v)


# globals built lazily (stdlib import avoids a cycle at module load)
_GLOBALS_CACHE: Optional[_Env] = None


def _globals_env() -> _Env:
    global _GLOBALS_CACHE
    if _GLOBALS_CACHE is None:
        from .stdlib import build_globals

        env = _Env()
        for k, v in build_globals().items():
            env.declare(k, v)
        _GLOBALS_CACHE = env
    # each script gets a child env; globals stay immutable-by-convention
    return _GLOBALS_CACHE
