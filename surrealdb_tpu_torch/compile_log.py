"""First-launch log: every new kernel launch shape and the one-time kernel
build recorded, attributed, exportable.

Mirrors surrealdb_tpu/compile_log.py, where each new padded shape of a
jitted kernel was an XLA compile. Here the kernels are built once per
process (ops/_cuda.py, subsystem `kernel_build`) and each new launch shape
is a first launch, which pays the build when it is the first of all. This
module wraps the kernel call sites (idx/knn.py, idx/ivf.py,
idx/graph_csr.py, ops/bm25.py for idx/ft_mirror.py and idx/ft_index.py,
ml/model.py):

- the FIRST call per (subsystem, shape key) is the first launch: its
  duration, subsystem, shape and mode land in a bounded event log, a
  `compile_events{subsystem,mode}` counter and a `kernel_compile`
  duration histogram;
- `mode` is `prewarm` when a background warmer launched it, `on_demand`
  when it happened under (or on behalf of) a live request — in which case
  a `kernel_compile` span is recorded into exactly ONE trace (the active
  request's, or the dispatch batch's first rider via the attribution
  contextvar dbs/dispatch.py sets);
- subsequent calls count as `compile_cache{subsystem,shape,outcome=hit}`.

Shape keys are value tuples of static dims (tile, dim, cap, k, ...). The
log is bounded by SURREAL_COMPILE_LOG_CAP. KERNEL_SITES names, for every
subsystem passed to tracked(), the kernels that subsystem launches.
"""

from __future__ import annotations

import contextvars
from surrealdb_tpu_torch.utils import locks as _locks
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Optional, Tuple

# ---------------------------------------------------------------- registry
# subsystem -> the kernel entry points (csrc/*.cu, through ops/distances.py,
# idx/ivf.py, idx/graph_csr.py, ops/bm25.py, ml/model.py and
# parallel/mesh.py) its tracked calls launch. Keys are EXACTLY the
# subsystem strings passed to tracked().
KERNEL_SITES = {
    "knn_exact": ("knn_pairwise", "knn_select"),
    "ivf": ("knn_pairwise", "knn_select", "ivf_rerank", "mesh_topk_merge"),
    "graph_dense": ("graph_dense_count",),
    "graph_csc": ("graph_csc_count",),
    "graph_chain": ("graph_chain",),
    "bm25": ("bm25_scores",),
    "bm25_match": ("bm25_match_scores",),
    "ml_forward": ("ml_linear", "ml_softmax"),
    "knn_sharded": ("knn_pairwise", "knn_select", "mesh_topk_merge"),
    "ivf_sharded": ("knn_pairwise", "knn_select", "ivf_rerank", "mesh_topk_merge"),
    "kernel_build": (
        "knn_pairwise", "knn_row_mean", "knn_select",
        "ivf_assign", "ivf_kmeans_update", "ivf_rerank",
        "graph_dense_count", "graph_csc_count", "graph_chain", "bm25_scores",
        "bm25_match_scores", "ml_linear", "ml_softmax", "mesh_topk_merge", "mesh_knn_2d",
        "mesh_frontier_hop", "mesh_dedup_frontier",
    ),
}


_lock = _locks.Lock("compile_log")
_seen: set = set()  # (subsystem, shape_key) already compiled
_inflight: set = set()  # keys whose FIRST call is still inside tracked()
_events: Deque[dict] = deque(maxlen=512)  # re-bounded lazily from cnf

# dispatch attribution: the leader launches kernels with tracing detached
# (spans are re-parented per rider), so an on-demand compile under a batch
# would otherwise be unattributable. dbs/dispatch.py parks the FIRST
# rider's SpanCtx here for the duration of the launch/collect/retry call.
_attr_ctx: "contextvars.ContextVar[Optional[Any]]" = contextvars.ContextVar(
    "surreal_compile_attr", default=None
)


@contextmanager
def attribution(trace_ctx) -> Any:
    """Attribute any compile inside this block to `trace_ctx` (a tracing
    SpanCtx) when no trace is otherwise active."""
    token = _attr_ctx.set(trace_ctx)
    try:
        yield
    finally:
        _attr_ctx.reset(token)


def _cap() -> int:
    from surrealdb_tpu_torch import cnf

    return max(cnf.COMPILE_LOG_CAP, 16)


def seen(subsystem: str, shape: Tuple) -> bool:
    with _lock:
        return (subsystem, shape) in _seen


@contextmanager
def tracked(subsystem: str, shape: Tuple, prewarmed: bool = False):
    """Wrap one shape-keyed kernel invocation. First call per key = the
    first-launch event (timed, logged, attributed); later calls = hits."""
    global _events
    from surrealdb_tpu_torch import telemetry

    key = (subsystem, tuple(shape))
    with _lock:
        first = key not in _seen
        if first:
            _seen.add(key)
            _inflight.add(key)
            waiting = False
        else:
            waiting = key in _inflight
    shape_label = "x".join(str(s) for s in shape)
    if not first:
        if not waiting:
            telemetry.inc(
                "compile_cache", subsystem=subsystem, shape=shape_label, outcome="hit"
            )
            yield False
            return
        # the first call is STILL running on another thread (e.g. a
        # prewarm warmer won the race and holds the build lock): record
        # this caller's wait as its own attributed event, not a phantom
        # instant "hit"
        telemetry.inc(
            "compile_cache", subsystem=subsystem, shape=shape_label, outcome="wait"
        )
        t0w = time.perf_counter()
        werr: Optional[BaseException] = None
        try:
            yield False
        except BaseException as e:
            werr = e
            raise
        finally:
            from surrealdb_tpu_torch import tracing

            dur = time.perf_counter() - t0w
            telemetry.observe("kernel_compile_wait", dur, subsystem=subsystem)
            sc = tracing.current()
            wctx = sc if sc is not None else _attr_ctx.get()
            if wctx is not None:
                tracing.record_span_into(
                    wctx, "kernel_compile_wait",
                    {"subsystem": subsystem, "shape": shape_label},
                    t0w, dur, werr,
                )
        return
    telemetry.inc(
        "compile_cache", subsystem=subsystem, shape=shape_label, outcome="miss"
    )
    t0 = time.perf_counter()
    err: Optional[BaseException] = None
    try:
        yield True
    except BaseException as e:
        err = e
        raise
    finally:
        dur = time.perf_counter() - t0
        from surrealdb_tpu_torch import tracing

        with _lock:
            _inflight.discard(key)
            if err is not None:
                # a failed first call did NOT leave a launched shape: the
                # next call through this shape is the real first launch
                # and must be recorded as one, not mislogged as a cache hit
                _seen.discard(key)
        ctx = None
        if not prewarmed:
            sc = tracing.current()
            ctx = sc if sc is not None else _attr_ctx.get()
        mode = "prewarm" if prewarmed else ("on_demand" if ctx is not None else "startup")
        trace_id = ctx.trace.trace_id if ctx is not None else None
        event = {
            "ts": time.time(),
            "subsystem": subsystem,
            "shape": shape_label,
            "duration_ms": round(dur * 1e3, 3),
            "mode": mode,
            "trace_id": trace_id,
            "error": type(err).__name__ if err is not None else None,
        }
        with _lock:
            if _events.maxlen != _cap():
                _events = deque(_events, maxlen=_cap())
            _events.append(event)
        telemetry.inc("compile_events", subsystem=subsystem, mode=mode)
        telemetry.observe("kernel_compile", dur, subsystem=subsystem, mode=mode)
        if ctx is not None:
            # exactly one trace carries the first-launch span: the request
            # that triggered it (or led the batch that did)
            tracing.record_span_into(
                ctx,
                "kernel_compile",
                {"subsystem": subsystem, "shape": shape_label, "mode": mode},
                t0,
                dur,
                err,
            )
            # pin that trace into the store regardless of tail sampling —
            # the event's trace_id must resolve via /trace/:id
            ctx.trace.force = True


# ------------------------------------------------------------------ views
def events(since: Optional[float] = None) -> list:
    """Logged compile events, oldest first (optionally only ts >= since)."""
    with _lock:
        out = list(_events)
    if since is not None:
        out = [e for e in out if e["ts"] >= since]
    return out


def snapshot() -> dict:
    """Compile-log section of the debug bundle."""
    from surrealdb_tpu_torch import telemetry

    evs = events()
    hits: dict = {}
    for labels, v in telemetry.counters_matching("compile_cache").items():
        d = dict(labels)
        hits[f"{d.get('subsystem')}:{d.get('shape')}:{d.get('outcome')}"] = int(v)
    return {
        "events": evs,
        "shapes_compiled": len(evs),
        "on_demand": sum(1 for e in evs if e["mode"] == "on_demand"),
        "prewarmed": sum(1 for e in evs if e["mode"] == "prewarm"),
        "cache": hits,
    }


def size() -> int:
    """Distinct (subsystem, shape) keys launched so far."""
    with _lock:
        return len(_seen)


def reset() -> None:
    with _lock:
        _seen.clear()
        _inflight.clear()
        _events.clear()
