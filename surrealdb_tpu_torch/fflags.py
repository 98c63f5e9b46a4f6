"""Feature-flag registry (role of the reference's fflags.rs: a single
place declaring togglable in-development features, each driven by an env
var, so experimental surfaces ship dark and flip on per deployment).

Usage:
    from surrealdb_tpu_torch.fflags import FFLAGS
    if FFLAGS.graphql_experimental:
        ...

Flags are read once at import; `reload()` re-reads the environment (tests).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

from surrealdb_tpu_torch import cnf


class _Flag(NamedTuple):
    env: str
    default: bool
    note: str


# name -> (env var, default, description)
_REGISTRY: Dict[str, _Flag] = {
    "graphql_experimental": _Flag(
        "SURREAL_EXPERIMENTAL_GRAPHQL", False,
        "GraphQL query endpoint generated from the table catalog",
    ),
    "bearer_access": _Flag(
        "SURREAL_EXPERIMENTAL_BEARER_ACCESS", True,
        "ACCESS ... TYPE BEARER grant lifecycle",
    ),
    "define_api": _Flag(
        "SURREAL_EXPERIMENTAL_DEFINE_API", False,
        "DEFINE API custom HTTP endpoints (not yet implemented)",
    ),
}

class _FFlags:
    def __init__(self):
        self.reload()

    def reload(self) -> None:
        for name, flag in _REGISTRY.items():
            setattr(self, name, cnf.env_bool(flag.env, flag.default))

    def snapshot(self) -> Dict[str, bool]:
        return {name: getattr(self, name) for name in _REGISTRY}


FFLAGS = _FFlags()


def enabled(name: str) -> bool:
    """Live read of one flag (request-time gates: tests flip the env var
    after import, so the gate must not rely on the import-time snapshot)."""
    flag = _REGISTRY[name]
    return cnf.env_bool(flag.env, flag.default)
