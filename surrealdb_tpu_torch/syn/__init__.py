"""Parser entry points (reference: core/src/syn/mod.rs:45-299)."""

from .parser import (
    Parser,
    parse_expr_text as parse_value,
    parse_kind_text as parse_kind,
    parse_query,
    parse_thing_text as parse_thing,
)

__all__ = ["Parser", "parse_query", "parse_value", "parse_thing", "parse_kind"]
