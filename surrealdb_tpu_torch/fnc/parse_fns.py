"""parse:: functions (reference: core/src/fnc/parse.rs)."""

from __future__ import annotations

from urllib.parse import urlparse

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import NONE

from . import register


def _s(v, name) -> str:
    if not isinstance(v, str):
        raise InvalidArgumentsError(name, "Expected a string.")
    return v


@register("parse::email::host")
def email_host(ctx, s):
    s = _s(s, "parse::email::host")
    return s.rpartition("@")[2] if "@" in s else NONE


@register("parse::email::user")
def email_user(ctx, s):
    s = _s(s, "parse::email::user")
    return s.rpartition("@")[0] if "@" in s else NONE


def _url(s, name):
    return urlparse(_s(s, name))


@register("parse::url::domain")
def url_domain(ctx, s):
    h = _url(s, "parse::url::domain").hostname
    return h if h else NONE


@register("parse::url::host")
def url_host(ctx, s):
    h = _url(s, "parse::url::host").hostname
    return h if h else NONE


@register("parse::url::fragment")
def url_fragment(ctx, s):
    f = _url(s, "parse::url::fragment").fragment
    return f if f else NONE


@register("parse::url::path")
def url_path(ctx, s):
    p = _url(s, "parse::url::path").path
    return p if p else NONE


@register("parse::url::port")
def url_port(ctx, s):
    p = _url(s, "parse::url::port").port
    return p if p is not None else NONE


@register("parse::url::query")
def url_query(ctx, s):
    q = _url(s, "parse::url::query").query
    return q if q else NONE


@register("parse::url::scheme")
def url_scheme(ctx, s):
    sc = _url(s, "parse::url::scheme").scheme
    return sc if sc else NONE
