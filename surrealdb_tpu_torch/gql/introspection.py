"""GraphQL introspection: `__schema` / `__type` generated from the catalog.

Role of the reference's dynamic schema generation (reference:
core/src/gql/schema.rs — every table becomes a root query field and an
object type whose fields come from the table's DEFINE FIELD statements,
with Kind mapped onto GraphQL scalars/objects). Here the schema is built
on demand as a plain dict tree shaped exactly like the spec's
introspection result (`__Schema`, `__Type`, `__Field`, `__InputValue`),
so the generic selection/projection machinery in exec.py can serve any
introspection query (including GraphiQL's fragment-heavy one) with no
special resolver layer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------- type refs


def _scalar(name: str) -> dict:
    return {"__typename": "__Type", "kind": "SCALAR", "name": name, "ofType": None}


def _named(name: str) -> dict:
    return {"__typename": "__Type", "kind": "OBJECT", "name": name, "ofType": None}


def _non_null(inner: dict) -> dict:
    return {"__typename": "__Type", "kind": "NON_NULL", "name": None, "ofType": inner}


def _list_of(inner: dict) -> dict:
    return {"__typename": "__Type", "kind": "LIST", "name": None, "ofType": inner}


# Custom scalars beyond the spec's five, mirroring the reference's
# kind->scalar mapping (core/src/gql/schema.rs kind_to_type).
_SCALARS = {
    "ID": "Record id (`table:key`)",
    "String": "UTF-8 string",
    "Int": "64-bit signed integer",
    "Float": "64-bit float",
    "Boolean": "true/false",
    "Datetime": "ISO-8601 datetime",
    "Duration": "SurrealQL duration (e.g. 1h30m)",
    "Uuid": "UUID string",
    "Decimal": "Arbitrary-precision decimal, serialized as a string",
    "Bytes": "Binary data",
    "Json": "Any JSON value (untyped / SurrealQL `any`, `object`, unions)",
}


def kind_to_type(kind, tables: set) -> dict:
    """Map a sql.kind.Kind (or None) to an introspection type ref.
    Non-option kinds are NON_NULL, matching the reference's treatment of
    required field TYPEs."""
    if kind is None:
        return _scalar("Json")
    name = kind.name
    if name == "option":
        inner = kind_to_type(kind.args[0], tables) if kind.args else _scalar("Json")
        return inner["ofType"] if inner["kind"] == "NON_NULL" else inner
    if name in ("array", "set"):
        inner = kind_to_type(kind.args[0], tables) if kind.args else _scalar("Json")
        return _non_null(_list_of(inner))
    if name == "record":
        tbs = [t for t in kind.args if t in tables]
        if len(tbs) == 1:
            return _non_null(_named(tbs[0]))
        return _non_null(_scalar("ID"))
    base = {
        "string": "String",
        "int": "Int",
        "float": "Float",
        "number": "Float",
        "decimal": "Decimal",
        "bool": "Boolean",
        "datetime": "Datetime",
        "duration": "Duration",
        "uuid": "Uuid",
        "bytes": "Bytes",
        "regex": "String",
    }.get(name, "Json")
    return _non_null(_scalar(base))


# ---------------------------------------------------------------- builders


def _input_value(name: str, type_ref: dict, desc: str = None) -> dict:
    return {
        "__typename": "__InputValue",
        "name": name,
        "description": desc,
        "type": type_ref,
        "defaultValue": None,
    }


def _field(name: str, type_ref: dict, args: List[dict] = None, desc: str = None) -> dict:
    return {
        "__typename": "__Field",
        "name": name,
        "description": desc,
        "args": args or [],
        "type": type_ref,
        "isDeprecated": False,
        "deprecationReason": None,
    }


def _obj_type(name: str, fields: List[dict], desc: str = None) -> dict:
    return {
        "__typename": "__Type",
        "kind": "OBJECT",
        "name": name,
        "description": desc,
        "fields": fields,
        "inputFields": None,
        "interfaces": [],
        "enumValues": None,
        "possibleTypes": None,
        "ofType": None,
    }


def _scalar_type(name: str, desc: str) -> dict:
    return {
        "__typename": "__Type",
        "kind": "SCALAR",
        "name": name,
        "description": desc,
        "fields": None,
        "inputFields": None,
        "interfaces": None,
        "enumValues": None,
        "possibleTypes": None,
        "ofType": None,
    }


_TABLE_ARGS_DESC = (
    "filter: {field: value} equality conjunction; order: field name or "
    "{field: ASC|DESC}; limit/start: paging"
)


def _table_args() -> List[dict]:
    return [
        _input_value("filter", _scalar("Json"), _TABLE_ARGS_DESC),
        _input_value("order", _scalar("Json")),
        _input_value("limit", _scalar("Int")),
        _input_value("start", _scalar("Int")),
    ]


def _is_top_level(name: str) -> bool:
    return all(c not in name for c in ".[*") and name.isidentifier()


def build_schema(ds, session) -> dict:
    """Build the full `__Schema` dict from the session database's catalog."""
    from surrealdb_tpu_torch.err import SurrealError

    ns, db = session.ns, session.db
    if not ns or not db:
        raise SurrealError("GraphQL requires a namespace and database on the session")
    txn = ds.transaction(False)
    try:
        tbs = txn.all_tb(ns, db)
        table_fields = {t["name"]: txn.all_tb_fields(ns, db, t["name"]) for t in tbs}
    finally:
        txn.cancel()

    table_names = {t["name"] for t in tbs if _is_top_level(t["name"])}
    types: List[dict] = [_scalar_type(n, d) for n, d in _SCALARS.items()]

    # one OBJECT type per table
    for t in sorted(table_names):
        fields = [_field("id", _non_null(_scalar("ID")))]
        seen = {"id"}
        for fd in table_fields.get(t, ()):
            fname = fd["name"]
            if not _is_top_level(fname) or fname in seen:
                continue
            seen.add(fname)
            fields.append(
                _field(
                    fname,
                    kind_to_type(fd.get("kind"), table_names),
                    desc=fd.get("comment"),
                )
            )
        types.append(_obj_type(t, fields, desc=f"Records of table `{t}`"))

    # the Query root: one field per table
    qfields = [
        _field(
            t,
            _non_null(_list_of(_non_null(_named(t)))),
            args=_table_args(),
            desc=f"Select records from table `{t}`",
        )
        for t in sorted(table_names)
    ]
    types.append(_obj_type("Query", qfields, desc="Root query type"))
    types.extend(_meta_types())

    by_name = {t["name"]: t for t in types}
    return {
        "__typename": "__Schema",
        "description": f"SurrealQL database `{ns}/{db}` exposed over GraphQL",
        "queryType": by_name["Query"],
        "mutationType": None,
        "subscriptionType": None,
        "types": types,
        "directives": _directives(),
        "_by_name": by_name,  # stripped before projection; see exec.py
    }


def _enum_type(name: str, values: List[str], desc: str = None) -> dict:
    return {
        "__typename": "__Type",
        "kind": "ENUM",
        "name": name,
        "description": desc,
        "fields": None,
        "inputFields": None,
        "interfaces": None,
        "enumValues": [
            {
                "__typename": "__EnumValue",
                "name": v,
                "description": None,
                "isDeprecated": False,
                "deprecationReason": None,
            }
            for v in values
        ],
        "possibleTypes": None,
        "ofType": None,
    }


def _meta_types() -> List[dict]:
    """The spec's own meta types, present so `types` is closed under
    reachability (GraphQL codegen tools walk these)."""
    tr = _scalar("String")
    bool_nn = _non_null(_scalar("Boolean"))
    type_ref = {"__typename": "__Type", "kind": "OBJECT", "name": "__Type", "ofType": None}
    return [
        _obj_type(
            "__Schema",
            [
                _field("description", tr),
                _field("types", _non_null(_list_of(_non_null(type_ref)))),
                _field("queryType", _non_null(type_ref)),
                _field("mutationType", type_ref),
                _field("subscriptionType", type_ref),
                _field("directives", _non_null(_list_of(_non_null(_named("__Directive"))))),
            ],
        ),
        _obj_type(
            "__Type",
            [
                _field("kind", _non_null(_named("__TypeKind"))),
                _field("name", tr),
                _field("description", tr),
                _field("fields", _list_of(_non_null(_named("__Field")))),
                _field("interfaces", _list_of(_non_null(type_ref))),
                _field("possibleTypes", _list_of(_non_null(type_ref))),
                _field("enumValues", _list_of(_non_null(_named("__EnumValue")))),
                _field("inputFields", _list_of(_non_null(_named("__InputValue")))),
                _field("ofType", type_ref),
            ],
        ),
        _obj_type(
            "__Field",
            [
                _field("name", _non_null(_scalar("String"))),
                _field("description", tr),
                _field("args", _non_null(_list_of(_non_null(_named("__InputValue"))))),
                _field("type", _non_null(type_ref)),
                _field("isDeprecated", bool_nn),
                _field("deprecationReason", tr),
            ],
        ),
        _obj_type(
            "__InputValue",
            [
                _field("name", _non_null(_scalar("String"))),
                _field("description", tr),
                _field("type", _non_null(type_ref)),
                _field("defaultValue", tr),
            ],
        ),
        _obj_type(
            "__EnumValue",
            [
                _field("name", _non_null(_scalar("String"))),
                _field("description", tr),
                _field("isDeprecated", bool_nn),
                _field("deprecationReason", tr),
            ],
        ),
        _obj_type(
            "__Directive",
            [
                _field("name", _non_null(_scalar("String"))),
                _field("description", tr),
                _field("locations", _non_null(_list_of(_non_null(_named("__DirectiveLocation"))))),
                _field("args", _non_null(_list_of(_non_null(_named("__InputValue"))))),
            ],
        ),
        _enum_type(
            "__TypeKind",
            ["SCALAR", "OBJECT", "INTERFACE", "UNION", "ENUM", "INPUT_OBJECT", "LIST", "NON_NULL"],
        ),
        _enum_type(
            "__DirectiveLocation",
            ["QUERY", "FIELD", "FRAGMENT_DEFINITION", "FRAGMENT_SPREAD", "INLINE_FRAGMENT"],
        ),
    ]


def _directives() -> List[dict]:
    inc = _input_value("if", _non_null(_scalar("Boolean")))
    return [
        {
            "__typename": "__Directive",
            "name": "include",
            "description": "Include this field only when `if` is true",
            "locations": ["FIELD", "FRAGMENT_SPREAD", "INLINE_FRAGMENT"],
            "args": [inc],
        },
        {
            "__typename": "__Directive",
            "name": "skip",
            "description": "Skip this field when `if` is true",
            "locations": ["FIELD", "FRAGMENT_SPREAD", "INLINE_FRAGMENT"],
            "args": [inc],
        },
    ]


def type_by_name(schema: dict, name: str) -> Optional[dict]:
    return schema["_by_name"].get(name)
