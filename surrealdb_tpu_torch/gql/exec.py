"""GraphQL query execution over the table catalog.

Role of the reference's gql module (reference: core/src/gql/schema.rs — a
dynamic schema where every table becomes a root query field with
filter/limit/start/order arguments, resolved by translating to SurrealQL).
This is a self-contained subset implementation (no external GraphQL
dependency): a spec-shaped lexer/parser for executable documents, then
translation of each root field into a SELECT through the normal engine
(permissions, planner, and capabilities all apply).

Supported: query operations (anonymous or named), variables, arguments
`limit`, `start`, `order` (field name, or {field: ASC|DESC}), `filter`
({field: value} equality conjunction), field selections with aliases,
nested selection sets on record links (resolved by fetching the linked
record), named fragments + spreads, inline fragments with type
conditions, `@skip`/`@include` directives, `__typename`, and full
introspection (`__schema`/`__type`, served from gql/introspection.py so
GraphiQL and codegen clients work). Mutations/subscriptions report a
clean unsupported error.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.sql.value import Thing

_TOKEN = re.compile(
    r"""
    (?P<ws>[\s,]+|\#[^\n]*)
  | (?P<name>[_A-Za-z][_0-9A-Za-z]*)
  | (?P<float>-?\d+\.\d+([eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<punct>\.\.\.|[!$():=@\[\]{}|])
    """,
    re.VERBOSE,
)


def _lex(src: str) -> List[Tuple[str, str]]:
    out, i = [], 0
    while i < len(src):
        m = _TOKEN.match(src, i)
        if m is None:
            raise SurrealError(f"GraphQL syntax error at offset {i}")
        i = m.end()
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, src: str):
        self.toks = _lex(src)
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def eat(self, kind: str, value: Optional[str] = None) -> bool:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise SurrealError(f"GraphQL syntax error: expected {value or kind}, got {v!r}")
        return v

    # ---------------------------------------------------------- document
    def document(self) -> Tuple[dict, Dict[str, dict]]:
        """Returns (the single executable operation, fragment defs by name)."""
        ops = []
        fragments: Dict[str, dict] = {}
        while self.peek()[0] != "eof":
            k, v = self.peek()
            if k == "punct" and v == "{":
                ops.append({"type": "query", "name": None, "vars": [], "sel": self.selection_set()})
            elif k == "name" and v in ("query", "mutation", "subscription"):
                self.next()
                if v != "query":
                    raise SurrealError(f"GraphQL {v} operations are not supported")
                name = None
                if self.peek()[0] == "name":
                    name = self.next()[1]
                var_defs = []
                if self.eat("punct", "("):
                    while not self.eat("punct", ")"):
                        self.expect("punct", "$")
                        vname = self.expect("name")
                        self.expect("punct", ":")
                        self._type_ref()
                        default = None
                        if self.eat("punct", "="):
                            default = self.value_node()
                        var_defs.append((vname, default))
                self._directives()
                ops.append({"type": "query", "name": name, "vars": var_defs, "sel": self.selection_set()})
            elif k == "name" and v == "fragment":
                self.next()
                fname = self.expect("name")
                if fname == "on":
                    raise SurrealError("GraphQL fragment may not be named 'on'")
                self.expect("name", "on")
                on = self.expect("name")
                self._directives()
                fragments[fname] = {"on": on, "sel": self.selection_set()}
            else:
                raise SurrealError(f"GraphQL syntax error near {v!r}")
        if len(ops) != 1:
            raise SurrealError("Exactly one GraphQL operation is supported per request")
        return ops[0], fragments

    def _type_ref(self) -> None:
        if self.eat("punct", "["):
            self._type_ref()
            self.expect("punct", "]")
        else:
            self.expect("name")
        self.eat("punct", "!")

    def selection_set(self) -> List[dict]:
        self.expect("punct", "{")
        out = []
        while not self.eat("punct", "}"):
            out.append(self.field())
        return out

    def _directives(self) -> List[dict]:
        """Parse `@name(args)` directives; only skip/include are honored."""
        out = []
        while self.eat("punct", "@"):
            name = self.expect("name")
            args: Dict[str, Any] = {}
            if self.eat("punct", "("):
                while not self.eat("punct", ")"):
                    an = self.expect("name")
                    self.expect("punct", ":")
                    args[an] = self.value_node()
            out.append({"name": name, "args": args})
        return out

    def field(self) -> dict:
        if self.eat("punct", "..."):
            # fragment spread or inline fragment
            k, v = self.peek()
            if k == "name" and v != "on":
                name = self.next()[1]
                dirs = self._directives()
                return {"spread": name, "dirs": dirs}
            on = None
            if k == "name" and v == "on":
                self.next()
                on = self.expect("name")
            dirs = self._directives()
            return {"inline": on, "dirs": dirs, "sel": self.selection_set()}
        name = self.expect("name")
        alias = None
        if self.eat("punct", ":"):
            alias, name = name, self.expect("name")
        args: Dict[str, Any] = {}
        if self.eat("punct", "("):
            while not self.eat("punct", ")"):
                an = self.expect("name")
                self.expect("punct", ":")
                args[an] = self.value_node()
        dirs = self._directives()
        sel = None
        if self.peek() == ("punct", "{"):
            sel = self.selection_set()
        return {"name": name, "alias": alias or name, "args": args, "sel": sel, "dirs": dirs}

    # ---------------------------------------------------------- values
    def value_node(self):
        """Parse a value tree; `_Var` markers resolve at execution time
        (variables may sit anywhere, including inside objects/lists)."""
        k, v = self.next()
        if k == "int":
            return int(v)
        if k == "float":
            return float(v)
        if k == "string":
            return _unquote(v)
        if k == "name":
            return {"true": True, "false": False, "null": None}.get(v, v)
        if k == "punct" and v == "$":
            return _Var(self.expect("name"))
        if k == "punct" and v == "[":
            out = []
            while not self.eat("punct", "]"):
                out.append(self.value_node())
            return out
        if k == "punct" and v == "{":
            out = {}
            while not self.eat("punct", "}"):
                key = self.expect("name")
                self.expect("punct", ":")
                out[key] = self.value_node()
            return out
        raise SurrealError(f"GraphQL syntax error near {v!r}")


def _unquote(s: str) -> str:
    import json

    return json.loads(s)


class _Var:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def _resolve(node, variables: Dict[str, Any]):
    """Deep-resolve _Var markers against the request's variables."""
    if isinstance(node, _Var):
        if node.name not in variables:
            raise SurrealError(f"Unknown GraphQL variable ${node.name}")
        return variables[node.name]
    if isinstance(node, list):
        return [_resolve(x, variables) for x in node]
    if isinstance(node, dict):
        return {k: _resolve(v, variables) for k, v in node.items()}
    return node


# ------------------------------------------------------------------ execution
_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _safe_ident(name: str, what: str) -> str:
    if not _IDENT.match(name):
        raise SurrealError(f"Invalid GraphQL {what} {name!r}")
    return name


class _Ctx:
    """Per-request execution context: engine handles + fragments + vars."""

    __slots__ = ("ds", "session", "fragments", "variables", "_schema")

    def __init__(self, ds, session, fragments, variables):
        self.ds = ds
        self.session = session
        self.fragments = fragments
        self.variables = variables
        self._schema = None

    def schema(self) -> dict:
        if self._schema is None:
            from .introspection import build_schema

            self._schema = build_schema(self.ds, self.session)
        return self._schema


def _dirs_keep(dirs, variables) -> bool:
    """Evaluate @skip/@include; unknown directives are ignored."""
    for d in dirs or ():
        if d["name"] in ("skip", "include"):
            cond = _resolve(d["args"].get("if"), variables)
            if d["name"] == "skip" and bool(cond):
                return False
            if d["name"] == "include" and not bool(cond):
                return False
    return True


def _expand_sel(ctx: _Ctx, sel: List[dict], typename: Optional[str], _seen=()) -> List[dict]:
    """Flatten fragment spreads / inline fragments into plain field nodes,
    applying type conditions against `typename` and skip/include."""
    out = []
    for node in sel:
        if "spread" in node:
            if not _dirs_keep(node.get("dirs"), ctx.variables):
                continue
            name = node["spread"]
            if name in _seen:
                raise SurrealError(f"GraphQL fragment cycle through {name!r}")
            frag = ctx.fragments.get(name)
            if frag is None:
                raise SurrealError(f"Unknown GraphQL fragment {name!r}")
            if typename is not None and frag["on"] not in (typename, "Record"):
                continue
            out.extend(_expand_sel(ctx, frag["sel"], typename, _seen + (name,)))
        elif "inline" in node:
            if not _dirs_keep(node.get("dirs"), ctx.variables):
                continue
            on = node["inline"]
            if on is not None and typename is not None and on not in (typename, "Record"):
                continue
            out.extend(_expand_sel(ctx, node["sel"], typename, _seen))
        else:
            if not _dirs_keep(node.get("dirs"), ctx.variables):
                continue
            out.append(node)
    return out


def run_graphql(ds, session, request: dict) -> dict:
    try:
        if not isinstance(request, dict):
            raise SurrealError("GraphQL request must be an object")
        vars_in = request.get("variables") or {}
        if not isinstance(vars_in, dict):
            raise SurrealError("GraphQL variables must be an object")
        op, fragments = _Parser(str(request.get("query") or "")).document()
        variables = dict(vars_in)
        for vname, default in op["vars"]:
            if vname not in variables and default is not None:
                variables[vname] = default
        ctx = _Ctx(ds, session, fragments, variables)
        data = {}
        for field in _collect(ctx, op["sel"], "Query"):
            data[field["alias"]] = _root_field(ctx, field)
        return {"data": data}
    except SurrealError as e:
        return {"errors": [{"message": str(e)}]}


def _strip_schema(v):
    """Drop the builder's internal `_by_name` index before projection."""
    if isinstance(v, dict):
        return {k: x for k, x in v.items() if k != "_by_name"}
    return v


def _root_field(ctx: _Ctx, field: dict):
    ds, session, variables = ctx.ds, ctx.session, ctx.variables
    if field["name"] == "__typename":
        return "Query"
    if field["name"] == "__schema":
        if field["sel"] is None:
            raise SurrealError("GraphQL field '__schema' requires a selection set")
        return _project(ctx, _strip_schema(ctx.schema()), field["sel"], depth=0)
    if field["name"] == "__type":
        from .introspection import type_by_name

        name = _resolve(field["args"].get("name"), variables)
        if not isinstance(name, str):
            raise SurrealError("GraphQL __type requires a string `name` argument")
        t = type_by_name(ctx.schema(), name)
        if t is None:
            return None
        if field["sel"] is None:
            raise SurrealError("GraphQL field '__type' requires a selection set")
        return _project(ctx, t, field["sel"], depth=0)
    tb = _safe_ident(field["name"], "table")
    ns, db = session.ns, session.db
    if not ns or not db:
        raise SurrealError("GraphQL requires a namespace and database on the session")

    sql = [f"SELECT * FROM {tb}"]
    vars: Dict[str, Any] = {}
    args = {k: _resolve(v, variables) for k, v in field["args"].items()}
    flt = args.get("filter") or args.get("where")
    if flt is not None:
        if not isinstance(flt, dict) or not flt:
            raise SurrealError("GraphQL filter must be a non-empty object")
        conds = []
        for i, (f, v) in enumerate(flt.items()):
            conds.append(f"{_safe_ident(f, 'field')} = $_gf{i}")
            vars[f"_gf{i}"] = v
        sql.append("WHERE " + " AND ".join(conds))
    order = args.get("order")
    if order is not None:
        if isinstance(order, dict) and len(order) == 1:
            f, d = next(iter(order.items()))
            direction = "DESC" if str(d).upper() == "DESC" else "ASC"
            sql.append(f"ORDER BY {_safe_ident(f, 'field')} {direction}")
        elif isinstance(order, str):
            sql.append(f"ORDER BY {_safe_ident(order, 'field')}")
        else:
            raise SurrealError("GraphQL order must be a field name or {field: ASC|DESC}")
    for arg_name, clause, var in (("limit", "LIMIT", "_glimit"), ("start", "START", "_gstart")):
        if args.get(arg_name) is not None:
            try:
                vars[var] = int(args[arg_name])
            except (TypeError, ValueError):
                raise SurrealError(f"GraphQL {arg_name} must be an integer")
            sql.append(f"{clause} ${var}")

    out = ds.execute(" ".join(sql) + ";", session, vars=vars)
    resp = out[-1]
    if resp["status"] != "OK":
        raise SurrealError(str(resp["result"]))
    rows = resp["result"]
    sel = field["sel"]
    if sel is None:
        raise SurrealError(f"GraphQL field '{tb}' requires a selection set")
    return [_project(ctx, row, sel, depth=0) for row in rows]


_MAX_LINK_DEPTH = 5


def _typename_of(row) -> Optional[str]:
    if isinstance(row, dict):
        tn = row.get("__typename")
        if isinstance(tn, str):
            return tn
        rid = row.get("id")
        if isinstance(rid, Thing):
            return rid.tb
    return None


def _collect(ctx: _Ctx, sel: List[dict], typename: Optional[str]) -> List[dict]:
    """Spec CollectFields: expand fragments, then merge fields that share a
    response key by concatenating their sub-selections (two fragments each
    selecting part of the same field must both contribute)."""
    merged: Dict[str, dict] = {}
    order: List[dict] = []
    for f in _expand_sel(ctx, sel, typename):
        key = f["alias"]
        prev = merged.get(key)
        if prev is None:
            f = dict(f)  # copy: merging must not mutate the parsed AST node
            merged[key] = f
            order.append(f)
        else:
            # spec FieldsInSetCanMerge: same response key requires the same
            # field and arguments — silently dropping one would return
            # wrong data
            if prev["name"] != f["name"] or prev.get("args") != f.get("args"):
                raise SurrealError(
                    f"GraphQL fields for key {key!r} cannot merge: "
                    "same response key with different fields or arguments"
                )
            if prev["sel"] is not None and f["sel"] is not None:
                prev["sel"] = prev["sel"] + f["sel"]
    return order


def _project(ctx: _Ctx, row, sel: List[dict], depth: int):
    out = {}
    for f in _collect(ctx, sel, _typename_of(row)):
        if f["name"] == "__typename":
            out[f["alias"]] = _typename_of(row) or "Record"
            continue
        v = row.get(f["name"]) if isinstance(row, dict) else None
        out[f["alias"]] = _render(ctx, v, f["sel"], depth)
    return out


def _render(ctx: _Ctx, v, sel, depth: int):
    if isinstance(v, list):
        return [_render(ctx, x, sel, depth) for x in v]
    if isinstance(v, Thing):
        if sel is None:
            return str(v)
        if depth >= _MAX_LINK_DEPTH:
            raise SurrealError("GraphQL record-link nesting too deep")
        out = ctx.ds.execute("SELECT * FROM $r;", ctx.session, vars={"r": v})
        rows = out[-1]["result"] if out[-1]["status"] == "OK" else []
        if not rows:
            return None
        return _project(ctx, rows[0], sel, depth + 1)
    if sel is not None:
        if isinstance(v, dict):
            return _project(ctx, v, sel, depth)
        return None
    from surrealdb_tpu_torch.sql.value import to_json_value

    return to_json_value(v)
