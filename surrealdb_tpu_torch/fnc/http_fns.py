"""`http::` functions — outbound HTTP, gated by the net-target capability.

Role of the reference's fnc/http.rs (head/get/put/post/patch/delete). Every
call passes two gates: the function capability (fnc.run, like any builtin)
and the net-target capability for the URL's host:port (reference checks the
resolved target before the request). Responses parse as JSON when the
server says so, otherwise return the raw text.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.sql.value import NONE

from . import register

_TIMEOUT = 30.0


def _do(ctx, method: str, url: Any, body=None, headers=None):
    if not isinstance(url, str):
        raise SurrealError(f"http::{method.lower()} expects a string url")
    from surrealdb_tpu_torch.dbs.capabilities import check_net_target

    check_net_target(ctx.capabilities(), url)
    if not url.lower().startswith(("http://", "https://")):
        raise SurrealError(f"invalid url {url!r}")

    import urllib.error
    import urllib.request

    hdrs = {}
    if headers is not None:
        if not isinstance(headers, dict):
            raise SurrealError("http:: headers must be an object")
        hdrs = {str(k): str(v) for k, v in headers.items()}
    data = None
    if body is not None and body is not NONE:
        if isinstance(body, (dict, list)):
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        elif isinstance(body, bytes):
            data = body
        else:
            data = str(body).encode()
    req = urllib.request.Request(url, data=data, headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=_TIMEOUT) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        raise SurrealError(f"There was an error processing a remote HTTP request: {e.code}")
    except (urllib.error.URLError, OSError) as e:
        raise SurrealError(f"There was an error processing a remote HTTP request: {e}")
    if method == "HEAD":
        return NONE
    if "json" in ctype:
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            pass
    try:
        return raw.decode()
    except UnicodeDecodeError:
        return raw


@register("http::head")
def _head(ctx, url, headers=None):
    return _do(ctx, "HEAD", url, None, headers)


@register("http::get")
def _get(ctx, url, headers=None):
    return _do(ctx, "GET", url, None, headers)


@register("http::put")
def _put(ctx, url, body=None, headers=None):
    return _do(ctx, "PUT", url, body, headers)


@register("http::post")
def _post(ctx, url, body=None, headers=None):
    return _do(ctx, "POST", url, body, headers)


@register("http::patch")
def _patch(ctx, url, body=None, headers=None):
    return _do(ctx, "PATCH", url, body, headers)


@register("http::delete")
def _delete(ctx, url, headers=None):
    return _do(ctx, "DELETE", url, None, headers)
