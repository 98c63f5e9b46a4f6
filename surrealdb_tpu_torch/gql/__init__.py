"""GraphQL endpoint (reference: core/src/gql/ — dynamic schema from table
DEFINEs, gated by SURREAL_EXPERIMENTAL_GRAPHQL, matching the reference's
experimental default-off). Enabled, requests execute via gql/exec.py: a
self-contained GraphQL subset parser + SurrealQL translation through the
normal engine, so permissions/planner/capabilities all apply."""

from __future__ import annotations

from surrealdb_tpu_torch.err import SurrealError


def execute_graphql(ds, session, request: dict):
    from surrealdb_tpu_torch import fflags

    if not fflags.enabled("graphql_experimental"):
        raise SurrealError("GraphQL is an experimental feature; set SURREAL_EXPERIMENTAL_GRAPHQL=true")
    from .exec import run_graphql

    return run_graphql(ds, session, request)
