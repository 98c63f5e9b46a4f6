"""The distributed scatter/gather executor — cluster mode's query brain.

Every statement arriving at a cluster node routes through here:

- **SELECT over tables/ranges** scatters a `SELECT * ... WHERE <cond>` to
  every member (each node's WHERE runs vectorized over ITS column mirror),
  gathers the raw row batches, re-sorts them into single-node scan order,
  and re-runs the ORIGINAL projection/GROUP/ORDER/LIMIT pipeline locally
  over the gathered rows — results stay byte-identical to one node.
- **kNN** scatters the statement with a `vector::distance::knn()` carrier
  field; per-shard top-k merge by distance yields the global top-k.
- **BM25 (MATCHES)** runs two-phase: per-node corpus stats (df/dc/avgdl)
  merge into GLOBAL stats that are injected into phase two, so every shard
  scores exactly as one corpus; score-merged rows feed the local pipeline.
- **Graph idioms** (`SELECT ->e->t FROM ...`) exchange frontier sets per
  hop: each hop broadcasts the frontier, every node expands the records it
  holds, and the per-id maps merge (max-multiplicity across nodes, so a
  replicated pointer key counts once) into the next frontier.
- **Writes** replicate by record ownership: CREATE/UPSERT/INSERT land on
  the hash owner PLUS its RF-1 ring successors (cnf.CLUSTER_RF, ids
  pre-generated so placement is deterministic), RELATE on the `from`
  record's replica set (edges colocate with their source on every copy),
  UPDATE/DELETE broadcast (non-holders match nothing). DDL broadcasts so
  schema exists on every member.

Fault tolerance (the RF-replication payoff):

- **Replica reads**: scatter reads tolerate up to RF-1 down nodes — every
  record a dead node owned has a live replica that already answered, so the
  gathered rows (deduplicated by record id) are still COMPLETE. The
  response carries a `degraded: true` flag and `cluster_failover_total`
  counts the covered failures. Beyond RF-1 down nodes the read errors
  clearly (coverage can no longer be proven).
- **Bounded retries**: IDEMPOTENT ops (reads, stats, expand, ping) retry on
  node failure with exponential backoff + jitter, capped per call
  (CLUSTER_RETRY_MAX) and per statement (CLUSTER_RETRY_BUDGET). Writes
  NEVER retry — a timed-out write may have applied, and a blind re-send
  would double-apply.
- **Degraded writes**: a write acks once every LIVE replica applied it; a
  down replica is tolerated (degraded, counted) and catches up only via
  rebalance (ROADMAP). With one node down a freshly-acked write still has
  ≥1 live copy, so a SINGLE failure never loses acknowledged data.
- **Admission control**: at most CLUSTER_MAX_INFLIGHT statements execute
  concurrently; a bounded wait queue absorbs bursts and everything beyond
  it sheds immediately with a retryable error (`cluster_shed_total`) —
  overload degrades to bounded latency, not collapse.

Unsupported in cluster mode (clear errors, never wrong answers): explicit
transactions, LIVE/KILL, FETCH, UPSERT on a bare table target, and — with
replication — write RETURN shapes that cannot be deduplicated by record id
(RETURN VALUE/DIFF/NULL on broadcast writes).
"""

from __future__ import annotations

import contextvars
import random as _random
import threading
import time as _time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.sql.ast import (
    FunctionCall,
    KnnOp,
    Literal,
    MatchesOp,
    ModelCall,
    Param,
    Subquery,
    walk_exprs,
)
from surrealdb_tpu_torch.sql.path import Idiom, PField, PGraph
from surrealdb_tpu_torch.sql.statements import (
    AccessStatement,
    AlterStatement,
    BeginStatement,
    CancelStatement,
    CommitStatement,
    CreateStatement,
    DefineStatement,
    DeleteStatement,
    Field,
    InfoStatement,
    InsertStatement,
    KillStatement,
    LetStatement,
    LiveStatement,
    OptionStatement,
    Query,
    RebuildStatement,
    RelateStatement,
    RemoveStatement,
    SelectStatement,
    ShowStatement,
    UpdateStatement,
    UpsertStatement,
    UseStatement,
)
from surrealdb_tpu_torch.sql.value import (
    NONE,
    Range,
    Table,
    Thing,
    generate_record_id,
    is_none,
)

from . import merge as _merge
from .client import ClusterError, NodeUnavailableError, RemoteOpError

_DIST = "__cluster_dist"
_SCORE = "__cluster_score"
_ROWS = "__cluster_rows"
_RID = "__cluster_rid"


class ClusterOverloadedError(ClusterError):
    """Admission control shed this statement — retryable by construction."""


def _fmt_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f}µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds:.3f}s"


def _ok(result) -> dict:
    return {"status": "OK", "result": result}


def _err(msg: str) -> dict:
    return {"status": "ERR", "result": msg}


class _StmtCtx:
    """Per-statement fault accounting AND the per-shard execution profile:
    the shared retry budget every scatter draws from, the degraded/
    failed-node view that ends up on the response, and — new with the
    observability plane — per-node RPC timing/row/retry/failover counts,
    admission wait, merge time, and the remote slow/error ring entries
    carried back on RPC responses. Mutated from pool threads — guarded by
    a raw lock."""

    __slots__ = (
        "degraded", "failed_nodes", "_budget", "_lock",
        "scatter_kind", "admission_wait_s", "merge_s", "rows_gathered",
        "retries", "shards", "remote_slow", "remote_errors", "pushdown",
        "executed_local", "fp", "tenant",
    )

    def __init__(self, budget: int):
        self.degraded = False
        self.failed_nodes: set = set()
        self._budget = max(int(budget), 0)
        self._lock = threading.Lock()
        self.scatter_kind: Optional[str] = None
        self.admission_wait_s = 0.0
        self.merge_s = 0.0
        self.rows_gathered: Optional[int] = None
        self.retries = 0
        # True once the statement ran through ds.execute_local (which does
        # its own ring + tenant accounting) — _account_statement must not
        # double-record, but a statement that neither scattered nor ran
        # locally (routing refusals, sheds) must not VANISH either
        self.executed_local = False
        # the coordinating statement's fingerprint + tenant: scatter-pool
        # threads activate these in the per-thread attribution tables so
        # profiler samples land on the statement, not an unattributed bucket
        self.fp: Optional[str] = None
        self.tenant: Optional[tuple] = None
        # node -> {"calls", "rpc_s", "max_rpc_s", "rows", "retries",
        #          "failovers", "errors", "partials"} (seconds internally;
        #          the profile renders milliseconds)
        self.shards: Dict[str, dict] = {}
        self.remote_slow: List[dict] = []
        self.remote_errors: List[dict] = []
        # pipeline-lowering accounting: {"agg": ...} / {"order_limit": k}
        self.pushdown: Optional[dict] = None

    def take_retry(self) -> bool:
        with self._lock:
            if self._budget <= 0:
                return False
            self._budget -= 1
            self.retries += 1
            return True

    def _shard(self, node_id: str) -> dict:
        sh = self.shards.get(node_id)
        if sh is None:
            sh = self.shards[node_id] = {
                "calls": 0, "rpc_s": 0.0, "max_rpc_s": 0.0, "rows": 0,
                "retries": 0, "failovers": 0, "errors": 0, "partials": 0,
            }
        return sh

    def record_partials(self, node_id: str, groups: int, rows: int) -> None:
        """One shard's partial-aggregate contribution: how many groups it
        returned and how many of its rows they aggregate — a skewed shard
        is attributable straight off the EXPLAIN ANALYZE Shard row."""
        with self._lock:
            sh = self._shard(node_id)
            sh["partials"] += groups
            sh["rows"] += rows

    def record_rpc(
        self, node_id: str, dur_s: float,
        rows: Optional[int] = None, error: bool = False, retry: bool = False,
    ) -> None:
        """One RPC attempt's contribution to the node's shard profile."""
        with self._lock:
            sh = self._shard(node_id)
            sh["calls"] += 1
            sh["rpc_s"] += dur_s
            sh["max_rpc_s"] = max(sh["max_rpc_s"], dur_s)
            if rows is not None:
                sh["rows"] += rows
            if error:
                sh["errors"] += 1
            if retry:
                sh["retries"] += 1

    def harvest_remote(self, node_id: str, resp: dict) -> None:
        """Remote-shard slow/error ring entries ride the RPC response
        (cluster/rpc.py) — collect them node-tagged so the coordinator's
        ring shows the cluster statement ONCE with a per-node breakdown."""
        slow = resp.get("slow")
        errs = resp.get("errors")
        if not slow and not errs:
            return
        with self._lock:
            for e in slow or []:
                if isinstance(e, dict):
                    self.remote_slow.append(dict(e, node=node_id))
            for e in errs or []:
                if isinstance(e, dict):
                    self.remote_errors.append(dict(e, node=node_id))

    def note_failover(self, node_id: str, kind: str = "read") -> None:
        from surrealdb_tpu_torch import events

        with self._lock:
            self.failed_nodes.add(node_id)
            self.degraded = True
            self._shard(node_id)["failovers"] += 1
        # timeline: the degraded read/write joins the statement's trace
        events.emit(
            "cluster.degraded_read" if kind == "read" else "cluster.degraded_write",
            node=node_id,
        )

    def profile(self, sql: str, kind: str, dur_s: float) -> dict:
        """The per-shard statement profile: the EXPLAIN ANALYZE payload,
        the slow-ring attachment, and the trace annotation — one shape."""
        with self._lock:
            shards = {
                n: {
                    "calls": sh["calls"],
                    "rpc_ms": round(sh["rpc_s"] * 1e3, 3),
                    "max_rpc_ms": round(sh["max_rpc_s"] * 1e3, 3),
                    "rows": sh["rows"],
                    "retries": sh["retries"],
                    "failovers": sh["failovers"],
                    "errors": sh["errors"],
                    "partials": sh.get("partials", 0),
                }
                for n, sh in sorted(self.shards.items())
            }
            out = {
                "sql": sql[:200],
                "kind": kind,
                "scatter": self.scatter_kind,
                "duration_ms": round(dur_s * 1e3, 3),
                "admission_wait_ms": round(self.admission_wait_s * 1e3, 3),
                "merge_ms": round(self.merge_s * 1e3, 3),
                "rows_gathered": self.rows_gathered,
                "retries": self.retries,
                "degraded": self.degraded,
                "failed_nodes": sorted(self.failed_nodes),
                "shards": shards,
            }
            if self.pushdown:
                out["pushdown"] = dict(self.pushdown)
            return out


_STMT: "contextvars.ContextVar[Optional[_StmtCtx]]" = contextvars.ContextVar(
    "cluster_stmt", default=None
)


class _Admission:
    """Semaphore-bounded statement admission with a bounded wait queue:
    inflight <= CLUSTER_MAX_INFLIGHT, at most CLUSTER_ADMIT_QUEUE waiters
    (each waiting at most CLUSTER_ADMIT_WAIT_SECS), everything else sheds
    fast — the coordinator's latency stays bounded under overload."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._inflight = 0
        self._waiters = 0

    def acquire(self) -> None:
        """Admit or shed. Returns normally once admitted; the caller's
        statement context records the wait as `admission_wait_ms` (the
        queue-wait slice of the per-shard profile)."""
        from surrealdb_tpu_torch import events, telemetry

        t0 = _time.perf_counter()
        cap = max(cnf.CLUSTER_MAX_INFLIGHT, 1)
        with self._cv:
            if self._inflight < cap:
                self._inflight += 1
                return
            if self._waiters >= max(cnf.CLUSTER_ADMIT_QUEUE, 0):
                reason = "queue_full"
            else:
                self._waiters += 1
                try:
                    deadline = _time.monotonic() + max(
                        cnf.CLUSTER_ADMIT_WAIT_SECS, 0.0
                    )
                    while self._inflight >= cap:
                        left = deadline - _time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    if self._inflight < cap:
                        self._inflight += 1
                        ctx = _STMT.get(None)
                        if ctx is not None:
                            ctx.admission_wait_s += _time.perf_counter() - t0
                        return
                    reason = "wait_timeout"
                finally:
                    self._waiters -= 1
        telemetry.inc("cluster_shed_total", reason=reason)
        events.emit("cluster.admission_shed", reason=reason)
        raise ClusterOverloadedError(
            "coordinator overloaded: statement shed by admission control "
            f"({reason}); the request is safe to retry"
        )

    def release(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify()

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"inflight": self._inflight, "waiting": self._waiters}


class ClusterExecutor:
    def __init__(self, ds, node):
        self.ds = ds
        self.node = node
        # persistent scatter pool: a fresh ThreadPoolExecutor per fan-out
        # would spawn+join N OS threads per statement — real churn at
        # coordinator qps. Sized for a few concurrent statements' worth of
        # scatters; deterministic thread names for stack dumps.
        self._pool = ThreadPoolExecutor(
            max_workers=max(4 * len(node.config.nodes), 8),
            thread_name_prefix="cluster-scatter",
        )
        self.admission = _Admission()
        # slowest per-shard profile since the last reset (bench artifacts
        # embed it; raw lock — leaf-only, never nests)
        self._profile_lock = threading.Lock()
        self._slowest_profile: Optional[dict] = None
        # write-degradation watermark at attach: the pipeline pushdowns
        # stand down once THIS cluster has degraded/diverged a write
        # (telemetry is process-global; the delta scopes it to this
        # executor's lifetime). A CLEAN anti-entropy sweep re-snapshots it
        # (reset_degradation) — repair proves convergence, so the
        # pushdowns resume instead of standing down forever.
        self._degradation0 = self._write_degradation()
        # epoch-guarded scatter-route cache (the cluster half of the plan
        # cache, dbs/plan_cache.py): SELECT classification — the graph /
        # colocated / agg / knn / bm25 / scan branch plus the refuse-wrong
        # errors — is a pure function of the statement SHAPE (literals
        # never change it), so it is cached per fingerprint and the AST
        # shape walks are skipped on repeat. A membership epoch bump
        # clears it (and notifies the datastore's plan cache).
        self._class_lock = threading.Lock()
        self._class_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._class_epoch: Optional[int] = None

    def reset_degradation(self) -> None:
        """Re-arm the pipeline pushdowns after repair proved the replicas
        converged (called by a clean repair.sweep_once pass)."""
        self._degradation0 = self._write_degradation()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------ profiles
    def _note_profile(self, profile: dict) -> None:
        with self._profile_lock:
            cur = self._slowest_profile
            if cur is None or profile["duration_ms"] > cur["duration_ms"]:
                self._slowest_profile = profile

    def slowest_profile(self) -> Optional[dict]:
        """The slowest scattered statement's per-shard profile since the
        last reset (bench config 7/8 artifacts embed it)."""
        with self._profile_lock:
            return dict(self._slowest_profile) if self._slowest_profile else None

    def reset_profiles(self) -> None:
        with self._profile_lock:
            self._slowest_profile = None

    # ------------------------------------------------------------ entry
    def execute(self, text: str, session, vars: Optional[Dict[str, Any]] = None) -> List[dict]:
        from surrealdb_tpu_torch import tracing
        from surrealdb_tpu_torch.syn import parse_query

        with tracing.request("cluster_execute", sql=text[:120]):
            ast = parse_query(text)
            out: List[dict] = []
            vars = dict(vars or {})
            sources = ast.sources or [repr(s) for s in ast.statements]
            for stm, src in zip(ast.statements, sources):
                t0 = _time.perf_counter()
                ctx = _StmtCtx(cnf.CLUSTER_RETRY_BUDGET)
                token = _STMT.set(ctx)
                admitted = False
                # workload statistics plane: the coordinated statement's
                # fingerprint — shard-local executions of the SAME text
                # (the scattered sub-queries) accumulate onto the same
                # fingerprint through each shard's own executor
                from surrealdb_tpu_torch import accounting, stats as _stats

                fp, _norm = _stats.fingerprint(src)
                tracing.annotate(fingerprint=fp)
                fp_tok = _stats.activate(fp)
                ctx.fp = fp
                ctx.tenant = (session.ns, session.db)
                a_tok = accounting.activate(session.ns, session.db)
                try:
                    self.admission.acquire()
                    admitted = True
                    resp = self._route(stm, src, session, vars)
                except ClusterError as e:
                    resp = _err(str(e))
                except SurrealError as e:
                    resp = _err(str(e))
                except Exception as e:  # noqa: BLE001 — mirror Executor's guard
                    resp = _err(f"Internal error: {type(e).__name__}: {e}")
                finally:
                    accounting.deactivate(a_tok)
                    _stats.deactivate(fp_tok)
                    _STMT.reset(token)
                    if admitted:
                        self.admission.release()
                if ctx.degraded:
                    # the answer is complete (replicas covered) but a node
                    # was down — callers polling for cluster health read it
                    # here instead of diffing counters
                    resp["degraded"] = True
                dt = _time.perf_counter() - t0
                self._account_statement(stm, src, session, ctx, resp, dt)
                resp["time"] = _fmt_time(dt)
                out.append(resp)
            return out

    def _account_statement(
        self, stm, src: str, session, ctx: _StmtCtx, resp: dict, dt: float
    ) -> None:
        """Close the observability loop on one coordinated statement: build
        the per-shard profile, pin it onto the request's trace, track the
        slowest one, and — when the statement was slow or errored — record
        it into the COORDINATOR's slow/error rings with the remote shards'
        own ring entries joined in (today a slow remote shard is only
        visible on the remote node; after this it shows up once, here,
        with the per-node breakdown)."""
        from surrealdb_tpu_torch import accounting, stats, telemetry, tracing

        if not ctx.shards:
            if ctx.executed_local:
                # the local execution path already did its own slow/error
                # + tenant accounting (dbs/executor.py)
                return
            # coordinator-level outcome with NO shard and NO local run
            # (routing refusals, admission sheds, LET binds): without this
            # the statement — and its session{ns,db} — vanished from every
            # ring; record it here, session-tagged, and charge the tenant
            self._account_coordinator_only(stm, src, session, resp, dt)
            return
        kind = type(stm).__name__
        profile = ctx.profile(src, kind, dt)
        tracing.annotate_append("cluster_profiles", profile)
        self._note_profile(profile)
        session_info = {
            "ns": session.ns,
            "db": session.db,
            "auth": getattr(session.auth, "level", None) or "anon",
        }
        errored = resp.get("status") == "ERR"
        slow = dt >= cnf.SLOW_QUERY_THRESHOLD_SECS
        notes = telemetry.drain_plan_notes()
        result = resp.get("result")
        # the coordinator's record carries the scatter-level decisions;
        # primary=None — the SCAN decision happened on the shards, whose
        # own executors record it under the same fingerprint (a scatter
        # record must not ping-pong the flip detector against them)
        fp, norm = stats.fingerprint(src)
        extra_mix = {"scatter": 1}
        if ctx.degraded:
            extra_mix["degraded"] = 1
        if getattr(ctx, "pushdown", None):
            extra_mix["agg-pushdown"] = 1
        stats.record(
            fp, norm, kind, dt,
            error=errored, slow=slow,
            rows_out=len(result) if isinstance(result, list) else (0 if errored else 1),
            plan=None, extra_mix=extra_mix, primary=None,
        )
        if errored:
            telemetry.inc("statement_errors", kind=kind)
            tracing.force_keep()
            telemetry.record_error(
                {
                    "ts": _time.time(),
                    "kind": kind,
                    "error": str(resp.get("result"))[:300],
                    "trace_id": tracing.current_trace_id(),
                    "fingerprint": fp,
                    "session": session_info,
                    "cluster": {
                        "shards": profile["shards"],
                        "remote_errors": list(ctx.remote_errors),
                    },
                }
            )
        if slow:
            telemetry.inc("slow_queries", kind=kind)
            tracing.force_keep()  # /slow -> /trace/:id must stay one hop
            telemetry.record_slow_query(
                {
                    "ts": _time.time(),
                    "sql": src[:500],
                    "kind": kind,
                    "duration_s": round(dt, 6),
                    "plan": notes,
                    "trace_id": tracing.current_trace_id(),
                    "fingerprint": fp,
                    "session": session_info,
                    "error": str(resp.get("result"))[:500] if errored else None,
                    "cluster": {
                        "profile": profile,
                        # the remote shards' OWN slow entries (their inner
                        # scattered statements), node-tagged
                        "remote_slow": list(ctx.remote_slow),
                    },
                }
            )
        # tenant accounting: the coordinator's OWN cost of this statement —
        # per-shard scatter RPC time (node breakdown) plus admission wait.
        # Shard-local executions charge their cpu/rows under the same
        # (ns, db) through their own executors; charging exec time here
        # too would double-count the tenant.
        with ctx._lock:
            shard_raw = {
                n: (sh["rpc_s"], sh["calls"]) for n, sh in ctx.shards.items()
            }
        total_rpc = 0.0
        for nid, (rpc_s, calls) in sorted(shard_raw.items()):
            total_rpc += rpc_s
            accounting.charge(
                session.ns, session.db, fingerprint=fp, node=nid,
                scatter_rpc_s=rpc_s, scatter_calls=calls,
            )
        telemetry.inc("scatter_rpc_seconds", by=total_rpc)
        if ctx.admission_wait_s:
            accounting.charge(
                session.ns, session.db, fingerprint=fp,
                admission_wait_s=ctx.admission_wait_s,
            )

    def _account_coordinator_only(
        self, stm, src: str, session, resp: dict, dt: float
    ) -> None:
        """Ring + tenant accounting for a statement that resolved entirely
        at the coordinator (no scatter, no local execution): routing
        refusals, admission sheds, LET binds. Errors/slow statements here
        used to skip every ring — and always dropped session{ns,db}."""
        from surrealdb_tpu_torch import accounting, stats, telemetry, tracing

        kind = type(stm).__name__
        errored = resp.get("status") == "ERR"
        slow = dt >= cnf.SLOW_QUERY_THRESHOLD_SECS
        fp, norm = stats.fingerprint(src)
        session_info = {
            "ns": session.ns,
            "db": session.db,
            "auth": getattr(session.auth, "level", None) or "anon",
        }
        stats.record(
            fp, norm, kind, dt, error=errored, slow=slow,
            rows_out=0, plan=None, extra_mix={"coordinator": 1}, primary=None,
        )
        accounting.charge(
            session.ns, session.db, fingerprint=fp,
            statements=1, errors=1 if errored else 0,
            slow=1 if slow else 0, exec_s=dt,
        )
        if errored:
            telemetry.inc("statement_errors", kind=kind)
            tracing.force_keep()
            telemetry.record_error(
                {
                    "ts": _time.time(),
                    "kind": kind,
                    "error": str(resp.get("result"))[:300],
                    "trace_id": tracing.current_trace_id(),
                    "fingerprint": fp,
                    "session": session_info,
                }
            )
        if slow:
            telemetry.inc("slow_queries", kind=kind)
            tracing.force_keep()
            telemetry.record_slow_query(
                {
                    "ts": _time.time(),
                    "sql": src[:500],
                    "kind": kind,
                    "duration_s": round(dt, 6),
                    "plan": None,
                    "trace_id": tracing.current_trace_id(),
                    "fingerprint": fp,
                    "session": session_info,
                    "error": str(resp.get("result"))[:500] if errored else None,
                }
            )

    # ------------------------------------------------------------ routing
    def _route(self, stm, src: str, session, vars) -> dict:
        if isinstance(stm, (BeginStatement, CommitStatement, CancelStatement)):
            return _err("explicit transactions are not supported in cluster mode")
        if isinstance(stm, (LiveStatement, KillStatement)):
            return _err("live queries are not supported in cluster mode")
        if isinstance(
            stm, (UseStatement, OptionStatement, InfoStatement, ShowStatement, AccessStatement)
        ):
            return self._local_stm(src, session, vars)
        if isinstance(stm, LetStatement):
            # bind on the coordinator; later scattered statements see the
            # value as an ordinary $param. A subquery here would read only
            # the coordinator's shard — refuse rather than answer wrong.
            if _has_subquery(stm.what):
                return _err(
                    "subqueries in LET read a single shard — not supported "
                    "in cluster mode (run the SELECT as its own statement)"
                )
            vars[stm.name] = self.ds.compute(stm.what, session, vars)
            return _ok(NONE)
        if isinstance(stm, (DefineStatement, RemoveStatement, AlterStatement, RebuildStatement)):
            return self._ddl_broadcast(src, session, vars)
        if isinstance(stm, SelectStatement):
            return self._select(stm, src, session, vars)
        if isinstance(
            stm,
            (UpdateStatement, DeleteStatement, CreateStatement, InsertStatement, RelateStatement),
        ) and _has_subquery(stm):
            # a subquery in a write's WHERE or data would evaluate over the
            # executing shard's partial data — refuse, never answer wrong
            return _err(
                "subqueries in write statements evaluate per shard — not "
                "supported in cluster mode (materialize the SELECT into a "
                "$param first)"
            )
        if isinstance(stm, UpsertStatement):
            return self._create_route(stm, session, vars, verb="UPSERT")
        if isinstance(stm, (UpdateStatement, DeleteStatement)):
            return self._write_broadcast(stm, src, session, vars)
        if isinstance(stm, CreateStatement):
            return self._create_route(stm, session, vars, verb="CREATE")
        if isinstance(stm, InsertStatement):
            return self._insert_route(stm, session, vars)
        if isinstance(stm, RelateStatement):
            return self._relate_route(stm, session, vars)
        # control flow / expressions (RETURN, IF, FOR, THROW, SLEEP, ...)
        # evaluate on the coordinator. An embedded subquery would read only
        # the coordinator's shard — a silent partial answer; refuse instead
        # ("unsupported shapes error clearly, never answer wrong").
        if _has_subquery(stm):
            return _err(
                "subqueries inside control-flow statements read a single "
                "shard — not supported in cluster mode (run the SELECT as "
                "its own statement)"
            )
        return self._local_stm(src, session, vars)

    # ------------------------------------------------------------ plumbing
    def _all_nodes(self) -> List[str]:
        """The statement fan-out set: the ACTIVE membership, plus any
        joining members during a handoff window (dual-read — a record
        mid-migration answers from wherever a copy lives)."""
        return self.node.member_ids()

    def _rf(self) -> int:
        """Effective replication factor: the knob clamped to the ACTIVE
        membership (the ring requests route under until cutover)."""
        return max(min(cnf.CLUSTER_RF, len(self.node.membership.nodes())), 1)

    def _down_nodes(self) -> set:
        client = self.node.client
        return set(client.down_nodes()) if client is not None else set()

    def _replicas(self, tb: str, rid) -> List[str]:
        """The record's replica set (primary first, ring order). During a
        membership handoff window this is the UNION of the active-ring and
        next-ring owners — dual-write, so the record exists on its new
        homes the moment the cutover lands."""
        from .placement import placement_key

        return self.node.membership.replicas_of_key(
            placement_key(tb, rid), self._rf()
        )

    def _call_once(self, node_id: str, op: str, req: Dict[str, Any]) -> Dict[str, Any]:
        """One cluster op; the self node short-circuits in-process (its
        spans nest naturally — no export/graft round trip)."""
        from surrealdb_tpu_torch import telemetry

        from . import rpc as _rpc

        if node_id == self.node.node_id:
            with telemetry.span("cluster_rpc", node=node_id, op=op):
                return _rpc._OPS[op](self.ds, req)
        return self.node.client.call(node_id, op, req)

    def _call(
        self, node_id: str, op: str, req: Dict[str, Any], idempotent: bool = False
    ) -> Dict[str, Any]:
        """One cluster op with the bounded retry policy: IDEMPOTENT ops
        retry on node failure with exponential backoff + jitter, capped per
        call and by the statement's shared retry budget. Writes never
        retry (a timed-out write may have applied — re-sending would
        double-apply); breaker fast-fails never retry (pointless); SLOW
        failures (the attempt burned a meaningful slice of the RPC
        deadline — the node is hanging, not glitching) never retry either:
        replica failover covers them at zero extra latency, while a blind
        retry would double the time a dead node costs."""
        from surrealdb_tpu_torch import telemetry

        attempt = 0
        while True:
            t0 = _time.monotonic()
            try:
                resp = self._call_once(node_id, op, req)
            except RemoteOpError:
                # the node is alive and EXECUTED the op but reported a
                # failure — the attempt still belongs in the shard profile
                # (a statement errored by one shard must name that shard)
                ctx = _STMT.get(None)
                if ctx is not None:
                    ctx.record_rpc(node_id, _time.monotonic() - t0, error=True)
                raise
            except NodeUnavailableError as e:
                ctx = _STMT.get(None)
                dur = _time.monotonic() - t0
                slow = dur >= 0.5 * max(cnf.CLUSTER_RPC_TIMEOUT_SECS, 0.1)
                if (
                    not idempotent
                    or slow
                    or not getattr(e, "retryable", True)
                    or attempt >= max(cnf.CLUSTER_RETRY_MAX, 0)
                    or ctx is None
                    or not ctx.take_retry()
                ):
                    if ctx is not None:
                        ctx.record_rpc(node_id, dur, error=True)
                    raise
                ctx.record_rpc(node_id, dur, error=True, retry=True)
                delay = min(
                    max(cnf.CLUSTER_RETRY_BASE_SECS, 0.001) * (2 ** attempt),
                    max(cnf.CLUSTER_RETRY_MAX_SECS, 0.001),
                )
                # full jitter halves the thundering-herd re-arrival spike
                _time.sleep(delay * (0.5 + 0.5 * _random.random()))
                attempt += 1
                telemetry.inc("cluster_retries", op=op)
            else:
                ctx = _STMT.get(None)
                if ctx is not None:
                    ctx.record_rpc(
                        node_id, _time.monotonic() - t0, rows=_resp_rows(resp)
                    )
                    ctx.harvest_remote(node_id, resp)
                return resp

    def _pooled_call(
        self, node_id: str, op: str, req: Dict[str, Any], idempotent: bool = False
    ) -> Dict[str, Any]:
        """`_call` wrapped for scatter-POOL threads: contextvars copied by
        `_fan_out` carry the trace and tenant CONTEXT, but the sampling
        profiler attributes cross-thread through the GIL-atomic
        thread-ident tables (stats.activate / accounting.activate) — so a
        pool worker must mark its statement's fingerprint and tenant
        active for ITS ident, or its samples land in the unattributed
        bucket while the coordinating thread sits idle in fut.result()."""
        from surrealdb_tpu_torch import accounting, stats as _stats

        ctx = _STMT.get(None)
        fp_tok = _stats.activate(ctx.fp) if ctx is not None and ctx.fp else None
        a_tok = (
            accounting.activate(*ctx.tenant)
            if ctx is not None and ctx.tenant is not None
            else None
        )
        try:
            return self._call(node_id, op, req, idempotent=idempotent)
        finally:
            if a_tok is not None:
                accounting.deactivate(a_tok)
            if fp_tok is not None:
                _stats.deactivate(fp_tok)

    def _fan_out(
        self,
        node_ids: List[str],
        op: str,
        req: Dict[str, Any],
        idempotent: bool = False,
        tolerate_down: bool = False,
    ) -> Dict[str, dict]:
        """Scatter one op to several nodes concurrently. With
        `tolerate_down` (replicated reads) up to RF-1 distinct DOWN nodes
        are survivable: their records have live replicas that already
        answered, so the partial gather is still complete — the statement
        flags `degraded` and `cluster_failover_total` counts the failover.
        Everything else (op errors, too many nodes down) raises.
        Contextvars are copied into the pool threads so every remote call
        records into the coordinating request's trace."""
        from surrealdb_tpu_torch import telemetry

        if len(node_ids) == 1:
            nid = node_ids[0]
            try:
                return {nid: self._call(nid, op, req, idempotent=idempotent)}
            except NodeUnavailableError as e:
                if not self._tolerable(tolerate_down, e):
                    raise
                telemetry.inc("cluster_failover_total", op=op)
                return {}

        out: Dict[str, dict] = {}
        # one context COPY per target, captured on the submitting thread:
        # the workers then share the request's Trace object (span appends
        # are GIL-atomic) without sharing a Context
        futs = {
            nid: self._pool.submit(
                contextvars.copy_context().run,
                self._pooled_call, nid, op, req, idempotent,
            )
            for nid in node_ids
        }
        errs: List[BaseException] = []
        for nid, fut in futs.items():
            try:
                out[nid] = fut.result()
            except NodeUnavailableError as e:
                if self._tolerable(tolerate_down, e):
                    telemetry.inc("cluster_failover_total", op=op)
                else:
                    errs.append(e)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
        if errs:
            raise errs[0]
        return out

    def _tolerable(self, tolerate_down: bool, e: NodeUnavailableError) -> bool:
        """A node failure is survivable when replication can prove the
        answer still covers: at most RF-1 DISTINCT nodes down across this
        statement. Records the failover into the statement context."""
        if not tolerate_down:
            return False
        rf = self._rf()
        if rf <= 1:
            return False
        ctx = _STMT.get(None)
        if ctx is None:
            return False
        nid = getattr(e, "node_id", None)
        with ctx._lock:
            failed = set(ctx.failed_nodes)
            if nid is not None:
                failed.add(nid)
        if len(failed) > rf - 1:
            return False
        if nid is not None:
            ctx.note_failover(nid)
        return True

    def _scatter_sql(
        self, node_ids: List[str], sql: str, session, vars,
        idempotent: bool = False, tolerate_down: bool = False,
    ) -> Dict[str, List[dict]]:
        """Run one statement on several nodes; returns node -> responses.
        Any remote statement-level ERR raises (partial scatters must not
        silently drop a shard's rows)."""
        req = {
            "sql": sql,
            "ns": session.ns,
            "db": session.db,
            "vars": vars or None,
        }
        gathered = self._fan_out(
            node_ids, "query", req,
            idempotent=idempotent, tolerate_down=tolerate_down,
        )
        out: Dict[str, List[dict]] = {}
        for nid, resp in gathered.items():
            results = resp.get("results") or []
            for r in results:
                if r.get("status") != "OK":
                    raise SurrealError(
                        f"cluster node {nid!r}: {r.get('result')}"
                    )
            out[nid] = results
        return out

    def _gather_rows(
        self, per_node: Dict[str, List[dict]], dedup: bool = False,
        dedup_key: str = "id", session=None,
    ) -> List[Any]:
        """Concatenate per-node result rows in node-sorted order. With
        replication (`dedup`) rows that carry a record id appear once per
        holding replica. Identical copies keep the first (node-sorted,
        deterministic). Copies that DIFFER — a replica missed a write and
        is serving stale data — resolve by LAST-WRITER-WINS: the two
        holders' HLC stamps are fetched (one small RPC per remote holder,
        paid only on actual divergence) and the newer write serves; when
        stamps cannot decide, the EARLIEST replica in the record's ring
        order serves (the write-reporter rule, the pre-HLC behavior).
        Either way `cluster_read_divergence` counts it and a background
        read-repair back-fills the stale copies, so the divergence is
        self-healing instead of an operator chore. Rows without a usable
        id pass through."""
        from surrealdb_tpu_torch import telemetry

        from . import repair as _repair

        rows: List[Any] = []
        if not dedup:
            for nid in sorted(per_node):
                for resp in per_node[nid]:
                    r = resp.get("result")
                    if isinstance(r, list):
                        rows.extend(r)
                    elif r is not None and not is_none(r):
                        rows.append(r)
            return rows
        by_id: Dict[str, Tuple[int, str]] = {}  # repr(id) -> (out idx, src node)
        for nid in sorted(per_node):
            for resp in per_node[nid]:
                r = resp.get("result")
                batch = r if isinstance(r, list) else (
                    [r] if r is not None and not is_none(r) else []
                )
                for row in batch:
                    rid = row.get(dedup_key) if isinstance(row, dict) else None
                    if not isinstance(rid, Thing):
                        rows.append(row)
                        continue
                    key = repr(rid)
                    if key not in by_id:
                        by_id[key] = (len(rows), nid)
                        rows.append(row)
                        continue
                    idx, kept_nid = by_id[key]
                    if nid == kept_nid or row == rows[idx]:
                        continue
                    telemetry.inc("cluster_read_divergence")
                    winner = None
                    if session is not None:
                        winner = _repair.divergent_winner(
                            self.node, session.ns, session.db, rid,
                            (kept_nid, nid),
                        )
                        _repair.schedule_read_repair(
                            self.node, session.ns, session.db, rid
                        )
                    if winner is None:
                        # stamps could not decide: ring-order fallback
                        rank = {
                            n: i
                            for i, n in enumerate(self._replicas(rid.tb, rid.id))
                        }
                        winner = (
                            nid
                            if rank.get(nid, len(rank)) < rank.get(kept_nid, len(rank))
                            else kept_nid
                        )
                    if winner == nid:
                        rows[idx] = row
                        by_id[key] = (idx, nid)
        return rows

    def _local_stm(self, src: str, session, vars) -> dict:
        ctx = _STMT.get(None)
        if ctx is not None:
            # execute_local runs the single-node executor, which does its
            # own ring + tenant accounting — _account_statement must not
            # account this statement a second time
            ctx.executed_local = True
        out = self.ds.execute_local(src, session, vars)
        if not out:
            return _ok(NONE)
        return {"status": out[0]["status"], "result": out[0]["result"]}

    def _eval_exprs(self, exprs, session, vars) -> List[Any]:
        """Evaluate statement-target expressions on the coordinator (they
        are constants/params — tables, record ids, row objects)."""
        from surrealdb_tpu_torch.dbs.context import Context
        from surrealdb_tpu_torch.dbs.executor import Executor
        from surrealdb_tpu_torch.dbs.iterator import target_value

        ex = Executor(self.ds, session, vars)
        ctx = Context(ex, session)
        for name, value in (vars or {}).items():
            ctx.set_param(name, value)
        ex._open(False)
        try:
            return [target_value(ctx, e) for e in exprs]
        finally:
            ex._cancel()

    @staticmethod
    def _flatten_targets(vals) -> List[Any]:
        out: List[Any] = []
        for v in vals:
            if isinstance(v, (list, tuple)):
                out.extend(ClusterExecutor._flatten_targets(v))
            else:
                out.append(v)
        return out

    # ------------------------------------------------------------ DDL
    def _ddl_broadcast(self, src: str, session, vars) -> dict:
        """Schema changes require EVERY member — a DDL applied to a subset
        leaves the membership schema-diverged, which no later read can
        detect. A down node therefore errors the DDL (reads/writes degrade;
        schema does not)."""
        from surrealdb_tpu_torch import telemetry

        self._set_scatter_kind("ddl")
        with telemetry.span("cluster_scatter", kind="ddl"):
            per_node = self._scatter_sql(self._all_nodes(), src, session, vars)
        mine = per_node.get(self.node.node_id) or []
        return (
            {"status": mine[0]["status"], "result": mine[0]["result"]}
            if mine
            else _ok(NONE)
        )

    # ------------------------------------------------------------ writes
    def _write_broadcast(self, stm, src: str, session, vars) -> dict:
        """UPDATE/DELETE: every member applies the statement to its local
        copies (non-holders match nothing); merged rows dedup by record id
        (each record answers once per holding replica) and return in scan
        order. A down node is tolerated within RF-1 — its replicas applied
        the write; the dead copy catches up only via rebalance (degraded).

        Deliberately broadcast even for id-addressed targets: edge records
        colocate with their FROM record's owner (not their hash owner), so
        hash-routing `UPDATE knows:x` would miss the record entirely —
        correctness over the N-1 no-op RPCs."""
        from surrealdb_tpu_torch import telemetry

        rf = self._rf()
        out_kind = getattr(getattr(stm, "output", None), "kind", None)
        if rf > 1 and out_kind in ("fields", "diff", "null"):
            return _err(
                "RETURN VALUE/DIFF/NULL on a broadcast write cannot be "
                "deduplicated across replicas — use RETURN AFTER, BEFORE "
                "or NONE in cluster mode"
            )
        self._set_scatter_kind("write")
        with telemetry.span("cluster_scatter", kind="write"):
            per_node = self._scatter_sql(
                self._all_nodes(), src, session, vars,
                tolerate_down=rf > 1,
            )
        rows = self._gather_rows(per_node, dedup=rf > 1, session=session)
        if rows and all(isinstance(r, dict) and "id" in r for r in rows):
            # FROM-source rank first (a multi-table UPDATE returns table by
            # table on a single node), key order within each source
            rows = _merge.sort_rows_scan_order(
                rows, self._from_tables(stm, session, vars)
            )
        if getattr(stm, "only", False):
            return _ok(rows[0] if rows else NONE)
        return _ok(rows)

    def _write_replicas(
        self, replicas: List[str], sql: str, session, vars,
    ) -> List[Any]:
        """One routed write against a record's replica set: every LIVE
        replica must apply it; a down replica is tolerated (degraded —
        rebalance owns the catch-up) as long as at least one copy landed.
        The FIRST live replica in ring order is the reporter whose output
        rows become the statement result (so RETURN shapes need no
        cross-replica dedup). Writes never retry."""
        from surrealdb_tpu_torch import telemetry

        req = {"sql": sql, "ns": session.ns, "db": session.db, "vars": vars or None}
        gathered: Dict[str, dict] = {}
        down: List[NodeUnavailableError] = []
        futs = {
            nid: self._pool.submit(
                contextvars.copy_context().run,
                self._call, nid, "query", req, False,
            )
            for nid in replicas
        }
        for nid, fut in futs.items():
            try:
                gathered[nid] = fut.result()
            except NodeUnavailableError as e:
                down.append(e)
        if not gathered:
            raise down[0] if down else SurrealError("write reached no replica")
        if down:
            ctx = _STMT.get(None)
            for e in down:
                telemetry.inc("cluster_failover_total", op="write")
                if ctx is not None and getattr(e, "node_id", None) is not None:
                    ctx.note_failover(e.node_id, kind="write")
        reporter = next(nid for nid in replicas if nid in gathered)
        results = gathered[reporter].get("results") or []
        for r in results:
            if r.get("status") != "OK":
                # the statement fails — but another replica may ALREADY
                # have applied it durably: that is a divergence (a 'failed'
                # write that reads can serve), and it must be counted, not
                # silent, exactly like the mirror case below
                for nid, resp in gathered.items():
                    if nid != reporter and all(
                        x.get("status") == "OK"
                        for x in resp.get("results") or []
                    ):
                        telemetry.inc("cluster_write_divergence")
                        break
                raise SurrealError(f"cluster node {reporter!r}: {r.get('result')}")
        # a NON-reporter replica that answered but failed the op leaves a
        # diverged copy behind: the write still acks (the canonical copy
        # landed) but degrades — rebalance owns the repair
        for nid, resp in gathered.items():
            if nid == reporter:
                continue
            if any(r.get("status") != "OK" for r in resp.get("results") or []):
                telemetry.inc("cluster_failover_total", op="write")
                ctx = _STMT.get(None)
                if ctx is not None:
                    ctx.note_failover(nid, kind="write")
        rows: List[Any] = []
        for resp in results:
            r = resp.get("result")
            if isinstance(r, list):
                rows.extend(r)
            elif r is not None and not is_none(r):
                rows.append(r)
        return rows

    def _create_route(self, stm, session, vars, verb: str) -> dict:
        """CREATE / UPSERT: each target record lands on its whole replica
        set (hash owner + RF-1 successors); bare-table CREATE pre-generates
        the id so placement is deterministic."""
        from surrealdb_tpu_torch import telemetry

        targets = self._flatten_targets(self._eval_exprs(stm.what, session, vars))
        things: List[Thing] = []
        for t in targets:
            if isinstance(t, Table):
                if verb == "UPSERT":
                    return _err(
                        "UPSERT on a bare table target is not supported in "
                        "cluster mode — name the record id"
                    )
                things.append(Thing(str(t), generate_record_id()))
            elif isinstance(t, Thing) and not isinstance(t.id, Range):
                things.append(t)
            elif isinstance(t, str):
                things.append(Thing.parse(t))
            else:
                return _err(f"{verb}: unsupported cluster target {t!r}")
        rows: List[Any] = []
        saved_what = stm.what
        self._set_scatter_kind("write")
        try:
            with telemetry.span("cluster_scatter", kind="write"):
                for t in things:
                    stm.what = [Literal(t)]
                    rows.extend(
                        self._write_replicas(
                            self._replicas(t.tb, t.id), repr(stm), session, vars
                        )
                    )
        finally:
            stm.what = saved_what
        if getattr(stm, "only", False):
            return _ok(rows[0] if rows else NONE)
        return _ok(rows)

    def _insert_route(self, stm, session, vars) -> dict:
        from surrealdb_tpu_torch import telemetry

        if stm.into is None:
            return _err("cluster INSERT requires an INTO table")
        if stm.update is not None:
            return _err(
                "INSERT ... ON DUPLICATE KEY UPDATE is not supported in "
                "cluster mode yet"
            )
        into = self._flatten_targets(self._eval_exprs([stm.into], session, vars))
        if len(into) != 1 or not isinstance(into[0], Table):
            return _err("cluster INSERT requires a plain table target")
        tb = str(into[0])
        rows = self._insert_rows(stm, session, vars)
        # pre-assign missing ids so placement is deterministic, then route
        # each row to its replica set (owner + RF-1 ring successors)
        by_replicas: Dict[Tuple[str, ...], List[Tuple[int, dict]]] = {}
        for i, row in enumerate(rows):
            if not isinstance(row, dict):
                return _err("cluster INSERT rows must be objects")
            row = dict(row)
            if stm.relation:
                src = row.get("in")
                if not isinstance(src, Thing):
                    return _err("cluster INSERT RELATION rows need an `in` record id")
                # pre-assign the EDGE id too: each replica executing the
                # routed batch must materialize the same edge record
                rid = row.get("id")
                if rid is None or is_none(rid):
                    row["id"] = generate_record_id()
                replicas = self._replicas(src.tb, src.id)
            else:
                rid = row.get("id")
                if rid is None or is_none(rid):
                    row["id"] = generate_record_id()
                    rid = row["id"]
                if isinstance(rid, Thing):
                    rid = rid.id
                replicas = self._replicas(tb, rid)
            by_replicas.setdefault(tuple(replicas), []).append((i, row))
        from surrealdb_tpu_torch.sql.value import escape_ident

        # InsertStatement repr does not round-trip (Data repr prints a
        # CONTENT keyword INSERT's grammar rejects) — build the routed
        # statement text directly
        sql = (
            "INSERT "
            + ("RELATION " if stm.relation else "")
            + ("IGNORE " if stm.ignore else "")
            + f"INTO {escape_ident(tb)} ${_ROWS}"
        )
        indexed: List[Tuple[int, Any]] = []
        self._set_scatter_kind("write")
        with telemetry.span("cluster_scatter", kind="write"):
            for replicas, batch in by_replicas.items():
                got = self._write_replicas(
                    list(replicas), sql, session,
                    dict(vars or {}, **{_ROWS: [r for _, r in batch]}),
                )
                indexed.extend(_align_insert_rows(tb, batch, got))
        indexed.sort(key=lambda p: p[0])
        return _ok([r for _, r in indexed])

    def _insert_rows(self, stm, session, vars) -> List[dict]:
        """Materialize the INSERT payload into a list of row objects."""
        data = stm.data
        if data is None:
            return []
        if data.kind == "content":
            v = self._eval_exprs([data.items], session, vars)[0]
            if isinstance(v, Table):  # a bare identifier is not rows
                raise SurrealError("cluster INSERT payload must be object(s)")
            rows = v if isinstance(v, list) else [v]
            return [dict(r) if isinstance(r, dict) else r for r in rows]
        if data.kind == "values":
            fields, tuples = data.items
            names = [repr(f) for f in fields]
            out = []
            for tup in tuples:
                vals = self._eval_exprs(list(tup), session, vars)
                row: Dict[str, Any] = {}
                for name, v in zip(names, vals):
                    if isinstance(v, Table):
                        v = str(v)
                    row[name] = v
                out.append(row)
            return out
        raise SurrealError(f"cluster INSERT cannot route {data.kind!r} payloads")

    def _relate_route(self, stm, session, vars) -> dict:
        """RELATE lands on the FROM record's replica set — an edge record
        and its pointer keys colocate with every copy of the source record,
        which is what keeps outbound graph expansion answerable after the
        source's primary dies.

        Edge ids are pre-generated ON THE COORDINATOR, one per
        (from, with) pair: letting each replica mint its own random edge
        id would leave the copies permanently diverged (the same edge
        under two names), so the product expands here and every replica
        executes the identical `RELATE from->edge:id->with` statement."""
        from surrealdb_tpu_torch import telemetry

        froms = self._flatten_targets(self._eval_exprs([stm.from_], session, vars))
        withs = self._flatten_targets(self._eval_exprs([stm.with_], session, vars))
        for t in froms + withs:
            if not isinstance(t, Thing):
                return _err("cluster RELATE requires record-id FROM/WITH targets")
        kind_v = self._eval_exprs([stm.kind], session, vars)[0]
        if isinstance(kind_v, Thing):
            edge_of = lambda f, w: kind_v  # explicit edge id: keep it
        elif isinstance(kind_v, (Table, str)):
            tb_kind = str(kind_v)
            edge_of = lambda f, w: Thing(tb_kind, generate_record_id())
        else:
            return _err(f"cluster RELATE cannot route via {kind_v!r}")

        by_replicas: Dict[Tuple[str, ...], List[Tuple[Thing, Thing, Thing]]] = {}
        for f in froms:
            replicas = tuple(self._replicas(f.tb, f.id))
            for w in withs:
                by_replicas.setdefault(replicas, []).append((f, edge_of(f, w), w))
        saved = (stm.from_, stm.with_, stm.kind)
        rows: List[Any] = []
        self._set_scatter_kind("write")
        try:
            with telemetry.span("cluster_scatter", kind="write"):
                for replicas, pairs in by_replicas.items():
                    stmts = []
                    for f, e, w in pairs:
                        stm.from_, stm.kind, stm.with_ = (
                            Literal(f), Literal(e), Literal(w),
                        )
                        stmts.append(repr(stm))
                    rows.extend(
                        self._write_replicas(
                            list(replicas), "; ".join(stmts), session, vars,
                        )
                    )
        finally:
            stm.from_, stm.with_, stm.kind = saved
        if getattr(stm, "only", False):
            return _ok(rows[0] if rows else NONE)
        return _ok(rows)

    # ------------------------------------------------------------ SELECT
    def _select(self, stm, src: str, session, vars) -> dict:
        from surrealdb_tpu_torch import telemetry

        if getattr(stm, "explain", False):
            if not getattr(stm, "explain_analyze", False):
                return self._local_stm(src, session, vars)
            return self._explain_analyze(stm, session, vars)
        if getattr(stm, "fetch", None):
            return _err("FETCH is not supported in cluster mode yet")

        decision = self._classified(stm)
        if decision[0] == "err":
            return _err(decision[1])

        if decision[0] == "graph":
            # re-derive the shape from THIS request's parse — decision
            # tuples are plain data; AST nodes are never cached
            graph = self._graph_shape(stm)
            if graph is None:  # shape drifted from the cached decision
                return self._dispatch_select(
                    self._classify_select(stm), stm, session, vars
                )
            self._set_scatter_kind("graph")
            with telemetry.span("cluster_scatter", kind="graph"):
                return self._graph_select(stm, session, vars, graph)

        return self._dispatch_select(decision, stm, session, vars)

    def _dispatch_select(self, decision: tuple, stm, session, vars) -> dict:
        from surrealdb_tpu_torch import telemetry

        if decision[0] == "err":
            return _err(decision[1])
        if decision[0] == "colocated":
            self._set_scatter_kind("colocated")
            with telemetry.span("cluster_scatter", kind="colocated"):
                return self._colocated_select(stm, session, vars)
        if decision[0] == "agg":
            # GROUP BY aggregate pushdown: each shard returns partial
            # aggregates over its rows and the coordinator merges partials
            # instead of shipping + replaying every surviving row. Shapes
            # that cannot prove a byte-exact merge fall back to the full
            # gather-and-replay scatter below.
            resp = self._agg_pushdown(stm, session, vars)
            if resp is not None:
                return resp
        kind = decision[0] if decision[0] in ("knn", "bm25") else "scan"
        # operator nodes come from the fresh parse, never the cache
        knn = _find_operator(getattr(stm, "cond", None), KnnOp) if kind == "knn" else None
        matches = (
            _find_operator(getattr(stm, "cond", None), MatchesOp)
            if kind == "bm25"
            else None
        )
        if kind == "knn" and knn is None:
            kind = "scan"
        if kind == "bm25" and matches is None:
            kind = "scan"
        self._set_scatter_kind(kind)
        with telemetry.span("cluster_scatter", kind=kind):
            if knn is not None:
                return self._scatter_select(stm, session, vars, knn=knn)
            if matches is not None:
                return self._scatter_select(stm, session, vars, matches=matches)
            return self._scatter_select(stm, session, vars)

    # ------------------------------------------- SELECT classification
    # The scatter branch for a SELECT — graph / colocated / agg / knn /
    # bm25 / scan, plus the refuse-wrong errors — depends only on the
    # statement SHAPE (which clauses exist, which operators appear),
    # never on literal values, so it is a pure function of the statement
    # fingerprint. _classified() caches the decision tuple per
    # fingerprint, guarded by the membership epoch: a node joining or
    # leaving clears every cached route (and tells the datastore's plan
    # cache, which stamps epochs on its own routes). Only plain tuples
    # are cached — graph shapes and knn/matches operator NODES are
    # re-derived from each request's fresh parse at dispatch.

    _CLASS_CAP = 512

    def _classify_select(self, stm) -> tuple:
        if getattr(stm, "fetch", None):
            return ("err", "FETCH is not supported in cluster mode yet")
        if _has_subquery(getattr(stm, "cond", None)):
            # the scattered WHERE would resolve the inner SELECT over each
            # shard's PARTIAL data — wrong (often empty) membership sets
            return (
                "err",
                "subqueries in WHERE evaluate per shard — not supported in "
                "cluster mode (materialize the inner SELECT into a $param "
                "first)",
            )
        if _has_inbound_graph(getattr(stm, "cond", None)):
            # a row's OUTBOUND pointers are local to its owner (RELATE
            # routing), so outbound graph conds evaluate correctly per
            # shard — but INBOUND pointers live on the edge source's owner
            # and a per-shard check silently drops matches
            return (
                "err",
                "inbound (<- / <->) graph traversal in WHERE reads pointer "
                "keys on other shards — not supported in cluster mode",
            )

        if self._graph_shape(stm) is not None:
            return ("graph",)

        shape = self._projection_shape(stm)
        if shape == "unsupported":
            # a subquery / ml:: call in the projection would evaluate over
            # each shard's PARTIAL data (and imported models are per-node)
            return (
                "err",
                "subquery/ml projections evaluate per shard — not supported "
                "in cluster mode",
            )
        grouped = bool(getattr(stm, "group", None)) or bool(
            getattr(stm, "group_all", False)
        )
        if shape == "colocated":
            if grouped:
                # each shard would aggregate its slice and the coordinator
                # cannot merge arbitrary graph-projection aggregates —
                # concatenated partials are wrong
                return (
                    "err",
                    "GROUP over graph projections aggregates per shard — "
                    "not supported in cluster mode",
                )
            return ("colocated",)

        knn = _find_operator(getattr(stm, "cond", None), KnnOp)
        matches = _find_operator(getattr(stm, "cond", None), MatchesOp)
        if knn is None and matches is None and grouped:
            return ("agg",)
        if knn is not None:
            return ("knn",)
        if matches is not None:
            return ("bm25",)
        return ("scan",)

    def _classified(self, stm) -> tuple:
        from surrealdb_tpu_torch import telemetry

        ctx = _STMT.get(None)
        fp = getattr(ctx, "fp", None) if ctx is not None else None
        if fp is None or not cnf.PLAN_CACHE:
            return self._classify_select(stm)
        ep = self.node.membership.epoch
        stale = 0
        with self._class_lock:
            if self._class_epoch != ep:
                stale = len(self._class_cache)
                self._class_cache.clear()
                self._class_epoch = ep
            hit = self._class_cache.get(fp)
            if hit is not None:
                self._class_cache.move_to_end(fp)
        # telemetry + cross-plane notification AFTER the lock releases
        if stale:
            telemetry.inc("plan_cache_invalidations", stale, cause="epoch")
            self.ds.plan_cache.note_epoch(ep)
        if hit is not None:
            telemetry.inc("plan_cache_hits", kind="cluster_route")
            return hit
        decision = self._classify_select(stm)
        with self._class_lock:
            if self._class_epoch == ep:
                self._class_cache[fp] = decision
                self._class_cache.move_to_end(fp)
                while len(self._class_cache) > self._CLASS_CAP:
                    self._class_cache.popitem(last=False)
        return decision

    @staticmethod
    def _set_scatter_kind(kind: str) -> None:
        ctx = _STMT.get(None)
        if ctx is not None:
            ctx.scatter_kind = kind

    def _explain_analyze(self, stm, session, vars) -> dict:
        """EXPLAIN ANALYZE on a cluster statement: execute the scatter FOR
        REAL (flags stripped), then render the statement context's
        per-shard profile as plan operations — per-node RPC latency and
        rows, queue/admission wait, retries, failovers, merge time. The
        same profile is pinned onto the request's trace, so the slowest
        `Shard` row here matches the slowest `cluster_rpc` span there."""
        saved = (stm.explain, stm.explain_full, stm.explain_analyze)
        stm.explain = stm.explain_full = stm.explain_analyze = False
        t0 = _time.perf_counter()
        try:
            resp = self._select(stm, repr(stm), session, vars)
        finally:
            stm.explain, stm.explain_full, stm.explain_analyze = saved
        dur = _time.perf_counter() - t0
        if resp.get("status") != "OK":
            return resp
        ctx = _STMT.get(None)
        if ctx is None or not ctx.shards:
            # a shape that never scattered (LET-fed params etc.) still
            # answers with an Execute row so the output shape is stable
            return _ok([{
                "operation": "Execute",
                "detail": {"duration_ms": round(dur * 1e3, 3)},
            }])
        profile = ctx.profile(repr(stm), type(stm).__name__, dur)
        scatter_detail = {
            "kind": profile["scatter"],
            "nodes": len(profile["shards"]),
            "admission_wait_ms": profile["admission_wait_ms"],
        }
        if profile.get("pushdown"):
            scatter_detail["pushdown"] = profile["pushdown"]
        ops: List[dict] = [{
            "operation": "Cluster Scatter",
            "detail": scatter_detail,
        }]
        for node, sh in profile["shards"].items():
            ops.append({"operation": "Shard", "detail": dict(sh, node=node)})
        ops.append({
            "operation": "Merge",
            "detail": {
                "merge_ms": profile["merge_ms"],
                "rows_gathered": profile["rows_gathered"],
                "degraded": profile["degraded"],
                "failed_nodes": profile["failed_nodes"],
                "retries": profile["retries"],
            },
        })
        rows = resp.get("result")
        ops.append({
            "operation": "Execute",
            "detail": {
                "duration_ms": profile["duration_ms"],
                "rows": len(rows) if isinstance(rows, list) else (
                    0 if rows is None or is_none(rows) else 1
                ),
            },
        })
        return _ok(ops)

    # ---- shape analysis
    def _graph_shape(self, stm) -> Optional[Idiom]:
        """`SELECT [VALUE] <pure graph idiom> FROM ...` with no other
        clauses — the per-hop frontier-exchange shape."""
        fields = getattr(stm, "fields", None) or []
        if len(fields) != 1 or getattr(fields[0], "all", False):
            return None
        expr = fields[0].expr
        if not isinstance(expr, Idiom) or not expr.parts:
            return None
        if not all(
            isinstance(p, PGraph) and getattr(p, "cond", None) is None
            for p in expr.parts
        ):
            return None
        for attr in ("cond", "group", "order", "limit", "start", "split", "omit"):
            if getattr(stm, attr, None):
                return None
        if getattr(stm, "group_all", False):
            return None
        return expr

    def _projection_shape(self, stm) -> str:
        """How the projection may execute across shards:
        - "replay": evaluates over gathered plain rows (the universal path);
        - "colocated": graph hops / search:: functions — run the whole
          statement on every member; correct because RELATE routing keeps
          outbound neighborhoods local and FT mirrors are per-shard;
        - "unsupported": subqueries / ml:: calls would read PARTIAL data
          per shard (models are per-node) — must error, never answer wrong.
        """
        kind = ["replay"]

        def visit(node):
            if isinstance(node, (Subquery, ModelCall)):
                kind[0] = "unsupported"
            elif isinstance(node, PGraph):
                if node.dir != "out":
                    # inbound pointers live on the edge SOURCE's owner — a
                    # colocated per-shard evaluation silently returns
                    # partial neighbor sets (only the pure-idiom frontier-
                    # exchange shape resolves them)
                    kind[0] = "unsupported"
                elif kind[0] == "replay":
                    kind[0] = "colocated"
            elif kind[0] == "replay" and isinstance(node, FunctionCall):
                if node.name.startswith("search::") and node.name != "search::score":
                    kind[0] = "colocated"

        walk_exprs(getattr(stm, "fields", None), visit)
        walk_exprs(getattr(stm, "group", None), visit)
        walk_exprs(getattr(stm, "split", None), visit)
        return kind[0]

    def _from_tables(self, stm, session, vars) -> List[str]:
        try:
            targets = self._flatten_targets(self._eval_exprs(stm.what, session, vars))
        except SurrealError:
            return []
        return [str(t) for t in targets if isinstance(t, Table)]

    # ---- strategies
    def _colocated_select(self, stm, session, vars) -> dict:
        """Scatter the FULL statement (minus ORDER/LIMIT/START), gather the
        already-projected rows, then apply ordering/limit locally. With
        replication every holding replica answers, so the scattered
        projection gains an `id AS __cluster_rid` carrier to dedup by —
        VALUE-mode projections have nowhere to put it and refuse."""
        rf = self._rf()
        dedup = rf > 1
        if dedup and getattr(stm, "value_mode", False):
            return _err(
                "SELECT VALUE over colocated projections cannot carry the "
                "replica-dedup record id — project a field list in cluster "
                "mode (replication is on)"
            )
        saved = (stm.order, stm.limit, stm.start, stm.fields)
        try:
            stm.order = stm.limit = stm.start = None
            if dedup:
                stm.fields = list(stm.fields) + [
                    Field(_carrier_idiom("id"), alias=_carrier_idiom(_RID))
                ]
            per_node = self._scatter_sql(
                self._all_nodes(), repr(stm), session, vars,
                idempotent=True, tolerate_down=dedup,
            )
        finally:
            stm.order, stm.limit, stm.start, stm.fields = saved
        t_merge = _time.perf_counter()
        rows = self._gather_rows(
            per_node, dedup=dedup, dedup_key=_RID, session=session
        )
        if rows and all(isinstance(r, dict) and "id" in r for r in rows):
            rows = _merge.sort_rows_scan_order(rows, self._from_tables(stm, session, vars))
        elif dedup and rows and all(isinstance(r, dict) and _RID in r for r in rows):
            rows = _merge.sort_rows_scan_order_by(
                rows, _RID, self._from_tables(stm, session, vars)
            )
        if dedup:
            rows = _merge.strip_cluster_fields(rows)
        self._note_merge(t_merge, len(rows))
        if not (stm.order or stm.limit or stm.start):
            if getattr(stm, "only", False):
                return _ok(rows[0] if rows else NONE)
            return _ok(rows)
        post = SelectStatement(
            [_star_field()], [Param(_ROWS)],
            order=stm.order, limit=stm.limit, start=stm.start,
            only=getattr(stm, "only", False),
        )
        out = self.ds.process(
            Query([post]), session, dict(vars or {}, **{_ROWS: rows})
        )
        return {"status": out[0]["status"], "result": out[0]["result"]}

    @staticmethod
    def _write_degradation() -> float:
        """Degraded/diverged writes observed by this coordinator. A replica
        that missed an acked write serves an incomplete shard: the row-ship
        paths cover it (divergence-aware dedup keeps the surviving copy),
        but per-shard PARTIAL aggregates and per-shard top-k cuts count
        each record at exactly one responsible replica and would silently
        drop it — so the pipeline pushdowns stand down entirely once any
        write degradation exists, until rebalance/anti-entropy (ROADMAP)
        repairs the copies. Same caveat class as the r12 degraded-write
        catch-up note; per-coordinator knowledge, like the retry budget."""
        from surrealdb_tpu_torch import telemetry

        return telemetry.get_counter("cluster_failover_total", op="write") + sum(
            telemetry.counters_matching("cluster_write_divergence").values()
        )

    def _agg_pushdown(self, stm, session, vars) -> Optional[dict]:
        """Two-phase GROUP BY (the BM25 global-stats design generalized):
        scatter one `agg_partial` op, merge the per-shard partials on the
        coordinator, project + ORDER/LIMIT locally. Under replication each
        shard aggregates only rows it is the first live replica of, so a
        doc counts exactly once. Returns None to fall back to the full
        gather-and-replay scatter — shapes that cannot prove a byte-exact
        merge (float sums, NaN folds, cross-shard int/float ties) refuse
        rather than answer approximately."""
        from surrealdb_tpu_torch import telemetry
        from surrealdb_tpu_torch.ops import pipeline as _pl

        shape = _pl.grouped_shape(stm)
        if shape is None:
            telemetry.inc("cluster_agg", outcome="fallback_shape")
            return None
        if self._rf() > 1 and self._write_degradation() > self._degradation0:
            telemetry.inc("cluster_agg", outcome="fallback_degraded")
            return None
        if getattr(stm, "split", None) or getattr(stm, "omit", None):
            telemetry.inc("cluster_agg", outcome="fallback_shape")
            return None
        if len(stm.what) != 1:
            telemetry.inc("cluster_agg", outcome="fallback_shape")
            return None
        targets = self._flatten_targets(self._eval_exprs(stm.what, session, vars))
        if len(targets) != 1 or not isinstance(targets[0], Table):
            telemetry.inc("cluster_agg", outcome="fallback_shape")
            return None
        tb = str(targets[0])
        rf = self._rf()
        req_base = {
            "sql": repr(stm),
            "ns": session.ns,
            "db": session.db,
            "tb": tb,
            "vars": vars or None,
        }
        self._set_scatter_kind("agg")
        ctx = _STMT.get(None)
        gathered: Dict[str, dict] = {}
        for attempt in range(2):
            node_ids = self._all_nodes()
            req = dict(req_base)
            if rf > 1:
                down = self._down_nodes()
                live = [n for n in node_ids if n not in down] or node_ids
                req.update(live=live, rf=rf)
                node_ids = live
            try:
                with telemetry.span("cluster_scatter", kind="agg"):
                    gathered = self._fan_out(
                        node_ids, "agg_partial", req, idempotent=True
                    )
                break
            except NodeUnavailableError:
                # a believed-live node died mid-phase: re-plan once
                if rf <= 1 or attempt:
                    raise
        parts: List[dict] = []
        for nid in sorted(gathered):
            resp = gathered[nid]
            if resp.get("fallback") or not resp.get("exact", False):
                telemetry.inc("cluster_agg", outcome="fallback_inexact")
                return None
            parts.append(resp)
        t_merge = _time.perf_counter()
        merged = _pl.merge_partials(shape, parts)
        if merged is None:
            telemetry.inc("cluster_agg", outcome="fallback_tie")
            return None
        rows = self._project_grouped(shape, merged, session, vars)
        self._note_merge(t_merge, len(rows))
        if ctx is not None:
            # per-shard partial counts land in the profile only once the
            # pushdown is COMMITTED to answering: an abandoned attempt must
            # not stack its counts on the replay scatter's row accounting
            for nid in sorted(gathered):
                resp = gathered[nid]
                ctx.record_partials(
                    nid, len(resp.get("groups") or []), int(resp.get("rows") or 0)
                )
            ctx.pushdown = {"agg": True, "groups": len(rows)}
        telemetry.inc("cluster_agg", outcome="pushed")
        if stm.order or stm.limit is not None or stm.start is not None or getattr(stm, "only", False):
            post = SelectStatement(
                [_star_field()], [Param(_ROWS)],
                order=stm.order, limit=stm.limit, start=stm.start,
                only=getattr(stm, "only", False),
            )
            out = self.ds.process(
                Query([post]), session, dict(vars or {}, **{_ROWS: rows})
            )
            return {"status": out[0]["status"], "result": out[0]["result"]}
        return _ok(rows)

    def _project_grouped(self, shape, merged: List[dict], session, vars) -> List[dict]:
        """Merged partial groups -> final projected rows (the row path's
        `_assign_field` naming over aggregate values and global-first
        member values)."""
        from surrealdb_tpu_torch.dbs.context import Context
        from surrealdb_tpu_torch.dbs.executor import Executor
        from surrealdb_tpu_torch.dbs.iterator import _assign_field

        ex = Executor(self.ds, session, vars)
        ctx = Context(ex, session)
        ex._open(False)
        try:
            rows: List[dict] = []
            for grp in merged:
                row: dict = {}
                for gf, val, first in zip(shape.fields, grp["values"], grp["firsts"]):
                    _assign_field(ctx, row, gf.field, val if gf.agg is not None else first)
                rows.append(row)
            return rows
        finally:
            ex._cancel()

    def _scatter_select(self, stm, session, vars, knn=None, matches=None) -> dict:
        """The universal gather-then-replay strategy (see module doc)."""
        cond = getattr(stm, "cond", None)
        rf = self._rf()
        extra_proj = ""
        scatter_vars = dict(vars or {})
        if knn is not None:
            extra_proj = f", vector::distance::knn() AS {_DIST}"
        elif matches is not None:
            stats = self._ft_global_stats(stm, matches, session, vars)
            if stats is None:
                # no search index anywhere: every node falls back to the
                # naive containment operator — still scatter + replay
                ref = matches.ref
            else:
                if any(
                    stats["df"].get(t, 0) <= 0 for t in (stats.get("terms") or [])
                ):
                    return self._replay(stm, session, vars, [], knn, matches)
                scatter_vars["__cluster_ft_stats"] = {
                    "dc": stats["dc"], "tl": stats["tl"], "df": stats["df"],
                }
                ref = matches.ref
            extra_proj = f", search::score({ref if ref is not None else 0}) AS {_SCORE}"

        from_txt = ", ".join(repr(e) for e in stm.what)
        inner = f"SELECT *{extra_proj} FROM {from_txt}"
        if cond is not None:
            inner += f" WHERE {cond!r}"
        # LIMIT pushdown: each shard over-fetches exactly the global cap —
        # sound because a record's local rank on any holding node is never
        # worse than its global rank. With a lowerable ORDER BY the shards
        # sort by the SAME resolved keys (+ id, the key-order tiebreak the
        # coordinator's scan-order re-sort restores globally) and return
        # per-shard top-(start+limit) candidates instead of every survivor;
        # the replay re-sorts the union, so the merged result is the
        # single-node result over a provable candidate superset.
        push = self._static_limit(stm, session, vars)
        if (
            push is not None
            and knn is None
            and matches is None
            and not stm.group
            and not getattr(stm, "group_all", False)
            and not stm.split
        ):
            if not stm.order:
                inner += f" LIMIT {push}"
            else:
                order_sql = self._order_push_sql(stm, session, vars)
                if order_sql is not None:
                    inner += f"{order_sql} LIMIT {push}"
                    ctx = _STMT.get(None)
                    if ctx is not None:
                        ctx.pushdown = {"order_limit": push}

        per_node = self._scatter_sql(
            self._all_nodes(), inner, session, scatter_vars,
            idempotent=True, tolerate_down=rf > 1,
        )
        t_merge = _time.perf_counter()
        rows = self._gather_rows(per_node, dedup=rf > 1, session=session)
        if knn is not None:
            rows = _merge.merge_topk(rows, int(knn.k), _DIST)
        elif matches is not None:
            rows = _merge.sort_by_score(rows, _SCORE)
        else:
            rows = _merge.sort_rows_scan_order(
                rows, self._from_tables(stm, session, vars)
            )
        self._note_merge(t_merge, len(rows))
        return self._replay(stm, session, vars, rows, knn, matches)

    @staticmethod
    def _note_merge(t_start: float, rows: int) -> None:
        """Coordinator-side merge accounting for the per-shard profile."""
        ctx = _STMT.get(None)
        if ctx is not None:
            with ctx._lock:
                ctx.merge_s += _time.perf_counter() - t_start
                ctx.rows_gathered = (ctx.rows_gathered or 0) + rows

    def _replay(self, stm, session, vars, rows, knn, matches) -> dict:
        """Re-run the ORIGINAL statement shape over the gathered rows: the
        WHERE already ran on the shards (and the kNN/BM25 merge decided
        membership), so the cond drops; score/distance functions resolve
        from the carrier fields instead of a per-statement query executor."""
        saved = (stm.what, stm.cond, stm.fields, stm.order)
        try:
            stm.what = [Param(_ROWS)]
            stm.cond = None
            stm.fields = [_rewrite_field(f) for f in stm.fields]
            if stm.order:
                stm.order = [_rewrite_order(o) for o in stm.order]
            out = self.ds.process(
                Query([stm]), session, dict(vars or {}, **{_ROWS: rows})
            )
        finally:
            stm.what, stm.cond, stm.fields, stm.order = saved
        resp = {"status": out[0]["status"], "result": out[0]["result"]}
        if resp["status"] == "OK":
            resp["result"] = _merge.strip_cluster_fields(resp["result"])
        return resp

    def _order_push_sql(self, stm, session, vars) -> Optional[str]:
        """` ORDER BY ...` clause for the per-shard top-(start+limit) cut,
        or None when the statement's ORDER BY cannot be proven equivalent
        over raw rows: keys must resolve to plain source paths (the same
        resolver the columnar pipeline uses), over ONE table (the id
        tiebreak below equals global key order only within one table)."""
        from surrealdb_tpu_torch.ops.pipeline import resolve_order_specs
        from surrealdb_tpu_torch.sql.value import escape_ident

        if len(stm.what) != 1:
            return None
        if getattr(stm, "value_mode", False):
            # VALUE-mode ordering keys on the PROJECTED value (and digs the
            # order idiom into dict-valued cells) — no raw-doc ORDER BY the
            # shard can run reproduces that, so the per-shard cut would not
            # be a provable candidate superset; keep the full gather
            return None
        if self._rf() > 1 and self._write_degradation() > self._degradation0:
            # a diverged replica's stale order key could survive its
            # shard's top-k cut where the fresh copy would not — only the
            # full-gather replay stays provably exact (see _write_degradation)
            return None
        targets = self._flatten_targets(self._eval_exprs(stm.what, session, vars))
        if len(targets) != 1 or not isinstance(targets[0], Table):
            return None
        specs = resolve_order_specs(stm)
        if specs is None:
            return None
        if not specs:
            return ""  # ORDER BY is provably a no-op: plain LIMIT cut
        parts = [
            ".".join(escape_ident(n) for n in s.path.split("."))
            + (" ASC" if s.asc else " DESC")
            for s in specs
        ]
        if not any(s.path == "id" for s in specs):
            # key-order tiebreak: a shard's cut among tied rows must match
            # the coordinator's stable scan-order tie resolution
            parts.append("id ASC")
        return " ORDER BY " + ", ".join(parts)

    def _static_limit(self, stm, session, vars) -> Optional[int]:
        try:
            if stm.limit is None:
                return None
            vals = self._eval_exprs(
                [stm.limit] + ([stm.start] if stm.start is not None else []),
                session, vars,
            )
            limit = int(vals[0])
            start = int(vals[1]) if len(vals) > 1 else 0
            return limit + start
        except (SurrealError, TypeError, ValueError):
            return None

    def _ft_global_stats(self, stm, matches, session, vars) -> Optional[dict]:
        """Phase one of distributed BM25: merge every member's local corpus
        statistics into the global df/dc/avgdl the shards will score with.
        Under replication each node reports stats only for the docs it is
        the FIRST LIVE replica of (the coordinator ships its liveness
        view), so a doc counts exactly once — and a dead node's docs are
        covered by their surviving replicas."""
        tables = self._from_tables(stm, session, vars)
        if len(tables) != 1 or not isinstance(matches.l, Idiom):
            return None
        query = self._eval_exprs([matches.r], session, vars)[0]
        rf = self._rf()
        req = {
            "ns": session.ns,
            "db": session.db,
            "tb": tables[0],
            "field": repr(matches.l),
            "query": str(query),
        }
        for attempt in range(2):
            targets = self._all_nodes()
            if rf > 1:
                down = self._down_nodes()
                live = [n for n in targets if n not in down] or targets
                req = dict(req, live=live, rf=rf)
                targets = live
            try:
                gathered = self._fan_out(
                    targets, "ft_stats", req, idempotent=True
                )
                return _merge.merge_ft_stats(list(gathered.values()))
            except NodeUnavailableError:
                # a believed-live node died mid-phase: the failed call just
                # marked it down — re-plan responsibilities once and retry
                if rf <= 1 or attempt:
                    raise
        return None  # unreachable (the loop returns or raises)

    # ---- graph frontier exchange
    def _graph_select(self, stm, session, vars, idiom: Idiom) -> dict:
        rf = self._rf()
        targets = self._flatten_targets(self._eval_exprs(stm.what, session, vars))
        sources: List[Thing] = []
        for t in targets:
            if isinstance(t, Thing) and not isinstance(t.id, Range):
                sources.append(t)
            elif isinstance(t, Table):
                sources.extend(self._table_ids(str(t), session))
            else:
                return _err(f"graph SELECT: unsupported cluster source {t!r}")

        # per-hop frontier exchange: broadcast each level's unique ids;
        # every member expands the pointers IT holds (empty elsewhere), and
        # the per-id lists merge across nodes by MAX MULTIPLICITY — a
        # pointer key held by several replicas counts once, while distinct
        # edges on distinct nodes all survive (deterministic: node order)
        hop_maps: List[Dict[str, Any]] = []
        frontier: List[Thing] = list(dict.fromkeys(sources))
        for part in idiom.parts:
            if not frontier:
                hop_maps.append({})
                continue
            req = {
                "ns": session.ns,
                "db": session.db,
                "dir": part.dir,
                "what": list(part.what or []),
                "ids": frontier,
            }
            gathered = self._fan_out(
                self._all_nodes(), "expand", req,
                idempotent=True, tolerate_down=rf > 1,
            )
            exp: Dict[str, Any] = {}
            per_id_lists: Dict[str, List[list]] = {}
            for nid in sorted(gathered):
                for k, v in (gathered[nid].get("map") or {}).items():
                    if not isinstance(v, list) or not v:
                        continue
                    per_id_lists.setdefault(k, []).append(v)
            for k, lists in per_id_lists.items():
                exp[k] = _merge.merge_hop_lists(lists)
            hop_maps.append(exp)
            nxt: List[Thing] = []
            seen = set()
            for v in exp.values():
                for t in v if isinstance(v, list) else ([v] if isinstance(v, Thing) else []):
                    if isinstance(t, Thing) and repr(t) not in seen:
                        seen.add(repr(t))
                        nxt.append(t)
            frontier = nxt

        def expand(src: Thing) -> List[Any]:
            cur: List[Any] = [src]
            for mp in hop_maps:
                nxt: List[Any] = []
                for t in cur:
                    v = mp.get(repr(t)) if isinstance(t, Thing) else None
                    if isinstance(v, list):
                        nxt.extend(v)
                    elif v is not None and not is_none(v):
                        nxt.append(v)
                cur = nxt
            return cur

        f = stm.fields[0]
        if getattr(stm, "value_mode", False):
            rows: List[Any] = [expand(s) for s in sources]
        else:
            if f.alias is not None:
                key = (
                    f.alias.simple_name()
                    if isinstance(f.alias, Idiom) and f.alias.simple_name()
                    else repr(f.alias)
                )
            else:
                key = repr(idiom)
            rows = [{key: expand(s)} for s in sources]
        if getattr(stm, "only", False):
            return _ok(rows[0] if rows else NONE)
        return _ok(rows)

    def _table_ids(self, tb: str, session) -> List[Thing]:
        from surrealdb_tpu_torch.sql.value import escape_ident

        rf = self._rf()
        per_node = self._scatter_sql(
            self._all_nodes(), f"SELECT id FROM {escape_ident(tb)}", session, None,
            idempotent=True, tolerate_down=rf > 1,
        )
        rows = _merge.sort_rows_scan_order(
            self._gather_rows(per_node, dedup=rf > 1, session=session), [tb]
        )
        return [r["id"] for r in rows if isinstance(r, dict) and isinstance(r.get("id"), Thing)]


# ------------------------------------------------------------------ helpers
def _resp_rows(resp: dict) -> Optional[int]:
    """Rows returned by one cluster op response — the per-shard profile's
    `rows` feed (query results or expand maps; None for stats/pings)."""
    results = resp.get("results")
    if isinstance(results, list):
        n = 0
        for r in results:
            v = r.get("result") if isinstance(r, dict) else None
            if isinstance(v, list):
                n += len(v)
            elif v is not None and not is_none(v):
                n += 1
        return n
    mp = resp.get("map")
    if isinstance(mp, dict):
        return len(mp)
    return None


def _align_insert_rows(
    tb: str, batch: List[Tuple[int, dict]], got: List[Any]
) -> List[Tuple[int, Any]]:
    """Pair an owner's INSERT output rows back to their original input
    indexes. With IGNORE (or a unique-index skip) the output is SHORTER
    than the input, so positional zip would misattribute indexes and the
    cross-owner reassembly would reorder rows — match by record id when
    the inputs carry them, else fall back to positional pairing."""
    if len(got) == len(batch):
        return [(i, row) for (i, _), row in zip(batch, got)]
    by_id: Dict[str, Any] = {}
    for row in got:
        if isinstance(row, dict) and isinstance(row.get("id"), Thing):
            by_id[repr(row["id"])] = row
    out: List[Tuple[int, Any]] = []
    matched = 0
    for i, src in batch:
        rid = src.get("id") if isinstance(src, dict) else None
        if rid is None:
            continue
        key = repr(rid) if isinstance(rid, Thing) else repr(Thing(tb, rid))
        row = by_id.get(key)
        if row is not None:
            out.append((i, row))
            matched += 1
    if matched == len(got):
        return out
    # ids didn't resolve every output row (RELATION payloads, exotic ids):
    # keep the owner's own order, positionally
    return [(batch[j][0], row) for j, row in enumerate(got)]


def _has_subquery(node) -> bool:
    """True when an AST fragment (or whole statement) embeds a Subquery —
    shard-partial evaluation territory the cluster must refuse."""
    found = [False]

    def visit(n):
        if isinstance(n, Subquery):
            found[0] = True

    walk_exprs(node, visit)
    return found[0]


def _has_inbound_graph(node) -> bool:
    """True when a fragment traverses `<-` / `<->` edges: their pointer
    keys live on the edge source's owner, not the evaluating shard."""
    found = [False]

    def visit(n):
        if isinstance(n, PGraph) and n.dir != "out":
            found[0] = True

    walk_exprs(node, visit)
    return found[0]


def _find_operator(expr, klass):
    """A kNN/MATCHES operator reachable through ANDs (planner twin)."""
    if expr is None:
        return None
    if isinstance(expr, klass):
        return expr
    from surrealdb_tpu_torch.sql.ast import BinaryOp

    if isinstance(expr, BinaryOp) and expr.op in ("&&", "AND"):
        return _find_operator(expr.l, klass) or _find_operator(expr.r, klass)
    return None


def _star_field():
    return Field(None, all_=True)


def _carrier_idiom(name: str) -> Idiom:
    return Idiom([PField(name)])


def _rewrite_expr(expr):
    """search::score(...) / vector::distance::knn() -> the carrier fields
    the scatter projection added to every gathered row."""
    if isinstance(expr, FunctionCall):
        if expr.name == "search::score":
            return _carrier_idiom(_SCORE)
        if expr.name == "vector::distance::knn":
            return _carrier_idiom(_DIST)
    return expr


def _rewrite_field(f):
    if getattr(f, "all", False) or f.expr is None:
        return f
    new = _rewrite_expr(f.expr)
    if new is f.expr:
        return f
    # preserve the display name of the original expression when un-aliased
    alias = f.alias if f.alias is not None else _display_alias(f.expr)
    return Field(new, alias=alias)


def _display_alias(expr):
    from surrealdb_tpu_torch.dbs.iterator import field_display_name

    return Idiom([PField(field_display_name(expr))])


def _rewrite_order(o):
    from surrealdb_tpu_torch.sql.statements import OrderItem

    new = _rewrite_expr(o.idiom)
    if new is o.idiom:
        return o
    return OrderItem(new, asc=o.asc, collate=o.collate, numeric=o.numeric, rand=o.rand)
