"""Telemetry: labeled metrics, histograms, spans, slow-query log, profiler.

Role of the reference's telemetry stack (reference: src/telemetry/mod.rs:
43-99 — OTEL traces + HTTP/WS request metrics, RPC spans). This
environment has no OTLP collector, so the equivalent surface is:

- a process-global metrics registry: labeled counters, labeled gauges,
  and labeled histograms with fixed log-scale buckets, rendered as valid
  Prometheus text exposition (`_bucket`/`_sum`/`_count`) at GET /metrics;
- duration histograms fed by `span()`/`observe()` around statement
  execution, device dispatches, RPC methods and HTTP requests;
- a structured slow-query ring buffer (sql, duration, plan summary,
  dispatch stats, error) drained via `snapshot()` or GET /slow;
- span recording around statement execution and device dispatches,
  enabled by `--profile` / SURREAL_PROFILE=1 (spans cost nothing when
  disabled), drained via `snapshot()` or INFO-style inspection;
- `torch.profiler` hooks: `start_trace()/stop_trace()` capture a host +
  CUDA trace (chrome-trace JSON) into a directory, and
  `trace_annotation()` labels dispatch launch/collect phases inside it.
  Both degrade to no-ops when the profiler is unavailable.
"""

from __future__ import annotations

import threading
from surrealdb_tpu_torch.utils import locks as _locks
import time
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Deque, Dict, List, Optional, Tuple

_lock = _locks.Lock("telemetry.registry")
_enabled = False
_spans: Deque[Tuple[str, float, float]] = deque(maxlen=4096)  # (name, start, dur_s)

_LabelKey = Tuple[Tuple[str, str], ...]
_counters: Dict[Tuple[str, _LabelKey], float] = {}
_gauges: Dict[Tuple[str, _LabelKey], float] = {}
# family -> (buckets, {labels: [counts per bucket + overflow, sum, count, max]})
_hists: Dict[str, Tuple[Tuple[float, ...], Dict[_LabelKey, list]]] = {}
# summary view kept alongside the histograms (cheap INFO-style inspection)
_durations: Dict[str, List[float]] = {}  # labeled name -> [count, total_s, max_s]

# fixed log-scale buckets — one shared shape per unit so every duration /
# size / count metric is comparable and the exposition stays small
DURATION_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
COUNT_BUCKETS: Tuple[float, ...] = (
    1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
)

_SLOW_LOG_SIZE = 128
_slow: Deque[dict] = deque(maxlen=_SLOW_LOG_SIZE)

_tls = threading.local()  # per-thread plan notes for the slow-query log


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def _key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# ------------------------------------------------------------------ counters
def inc(name: str, by: float = 1.0, **labels) -> None:
    key = (name, _key(labels))
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + by


def get_counter(name: str, **labels) -> float:
    with _lock:
        return _counters.get((name, _key(labels)), 0.0)


def counters_matching(name: str) -> Dict[_LabelKey, float]:
    """All label-series of one counter family: {labels_tuple: value}."""
    with _lock:
        return {labels: v for (n, labels), v in _counters.items() if n == name}


def error_class(e: BaseException) -> str:
    """Stable low-cardinality error label for counters."""
    return type(e).__name__


# ------------------------------------------------------------------ gauges
def gauge_add(name: str, delta: float, **labels) -> None:
    key = (name, _key(labels))
    with _lock:
        _gauges[key] = _gauges.get(key, 0.0) + delta


def gauge_set(name: str, value: float, **labels) -> None:
    with _lock:
        _gauges[(name, _key(labels))] = float(value)


def gauges_matching(name: str) -> Dict[_LabelKey, float]:
    """All label-series of one gauge family: {labels_tuple: value}."""
    with _lock:
        return {labels: v for (n, labels), v in _gauges.items() if n == name}


# ------------------------------------------------------------------ histograms
def _hist_observe(family: str, buckets: Tuple[float, ...], value: float, labels: Dict) -> None:
    lk = _key(labels)
    with _lock:
        fam = _hists.get(family)
        if fam is None:
            fam = _hists[family] = (buckets, {})
        # first registration wins: a call site passing different buckets for
        # the same family is folded into the registered shape (bisect below
        # uses fam[0]) — a bookkeeping mismatch must never abort the query
        # path this instruments
        _, series = fam
        h = series.get(lk)
        if h is None:
            # per-bucket counts + overflow slot, then sum, count, max
            h = series[lk] = [0] * (len(fam[0]) + 1) + [0.0, 0, value]
        h[bisect_left(fam[0], value)] += 1
        h[-3] += value
        h[-2] += 1
        h[-1] = max(h[-1], value)


def observe_hist(name: str, value: float, buckets: Tuple[float, ...] = SIZE_BUCKETS, **labels) -> None:
    """Generic labeled histogram (batch widths, candidate counts, ...)."""
    _hist_observe(name, buckets, float(value), labels)


def observe(name: str, seconds: float, **labels) -> None:
    """Duration histogram `surreal_<name>_duration_seconds` + summary view."""
    _hist_observe(f"{name}_duration_seconds", DURATION_BUCKETS, seconds, labels)
    dname = name + (_fmt_labels(_key(labels)) if labels else "")
    with _lock:
        d = _durations.get(dname)
        if d is None:
            _durations[dname] = [1.0, seconds, seconds]
        else:
            d[0] += 1
            d[1] += seconds
            d[2] = max(d[2], seconds)


@contextmanager
def span(name: str, **labels: str):
    """Timed span: always feeds the duration histograms; becomes a node in
    the active request's span tree (tracing.py) when one exists; records
    the flat profiling entry only while profiling is enabled (reference
    #[instrument] spans). With no active trace and profiling off the extra
    cost is one ContextVar read."""
    from surrealdb_tpu_torch import tracing

    t0 = time.perf_counter()
    tok = tracing.push()
    err = None
    try:
        yield
    except BaseException as e:
        err = e
        raise
    finally:
        dur = time.perf_counter() - t0
        observe(name, dur, **labels)
        if tok is not None:
            tracing.pop(tok, name, labels, t0, dur, err)
        if _enabled:
            with _lock:
                _spans.append((name, t0, dur))


# ------------------------------------------------------------------ slow queries
def record_slow_query(entry: dict) -> None:
    """Append one structured slow-statement record to the ring buffer
    (replaces the print-based warning; reference: query duration warnings
    in telemetry/metrics)."""
    with _lock:
        _slow.append(entry)


def slow_queries() -> List[dict]:
    with _lock:
        return list(_slow)


# ------------------------------------------------------------------ error log
# Counters are label-bounded so they can't carry a trace_id; this bounded
# ring is the joinable side of statement_errors: each entry cites the
# request's trace_id + session info (ns/db/auth LEVEL — never tokens).
_ERROR_LOG_SIZE = 256
_errors: Deque[dict] = deque(maxlen=_ERROR_LOG_SIZE)


def record_error(entry: dict) -> None:
    with _lock:
        _errors.append(entry)


def recent_errors() -> List[dict]:
    with _lock:
        return list(_errors)


# ------------------------------------------------------------------ plan notes
def note_plan(note: dict) -> None:
    """Record a plan decision for the CURRENT thread's statement; the
    executor drains these into the slow-query record so a slow statement's
    entry says which index/strategy actually served it."""
    lst = getattr(_tls, "plan_notes", None)
    if lst is None:
        lst = _tls.plan_notes = []
    lst.append(note)
    del lst[:-8]  # bound per-statement accumulation


def drain_plan_notes() -> List[dict]:
    lst = getattr(_tls, "plan_notes", None)
    if not lst:
        return []
    out = list(lst)
    del lst[:]
    return out


# ------------------------------------------------------------------ profiler
_trace_dir: Optional[str] = None
_trace_prof = None  # the running torch.profiler.profile


def start_trace(outdir: str) -> bool:
    """Begin a `torch.profiler` capture (host, plus CUDA when a card is
    present) that stop_trace() writes into `outdir`; returns False (no-op)
    when the profiler is unavailable."""
    global _trace_dir, _trace_prof
    if _trace_dir is not None:
        return True
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        return False
    _trace_dir, _trace_prof = outdir, prof
    return True


def stop_trace() -> Optional[str]:
    """Finish the in-flight capture and write `<dir>/trace.json`; returns
    the directory or None."""
    global _trace_dir, _trace_prof
    if _trace_dir is None:
        return None
    out, prof = _trace_dir, _trace_prof
    _trace_dir, _trace_prof = None, None
    try:
        import os

        prof.__exit__(None, None, None)
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
    except Exception:
        return None
    return out


def trace_annotation(name: str):
    """Label a dispatch phase inside the device trace. Free when neither
    --profile nor a trace capture is active."""
    if not _enabled and _trace_dir is None:
        return nullcontext()
    try:
        from torch.profiler import record_function

        return record_function(name)
    except Exception:
        return nullcontext()


# ------------------------------------------------------------------ snapshot / reset
def snapshot() -> dict:
    """Current metrics + slow queries + (when profiling) recent spans."""
    with _lock:
        return {
            "counters": {
                name + (_fmt_labels(labels) if labels else ""): v
                for (name, labels), v in _counters.items()
            },
            "gauges": {
                name + (_fmt_labels(labels) if labels else ""): v
                for (name, labels), v in _gauges.items()
            },
            "durations": {
                name: {"count": int(d[0]), "total_s": round(d[1], 6), "max_s": round(d[2], 6)}
                for name, d in _durations.items()
            },
            "histograms": {
                fam + (_fmt_labels(labels) if labels else ""): {
                    "count": h[-2],
                    "sum": round(h[-3], 6),
                    "max": round(h[-1], 6),
                }
                for fam, (_, series) in _hists.items()
                for labels, h in series.items()
            },
            "slow_queries": list(_slow),
            "errors": list(_errors),
            "spans": [
                {"name": n, "start": s, "dur_ms": round(dur * 1e3, 3)}
                for n, s, dur in list(_spans)
            ]
            if _enabled
            else [],
        }


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _durations.clear()
        _spans.clear()
        _slow.clear()
        _errors.clear()


# ------------------------------------------------------------------ node metrics
def _jit_cache_stats() -> Optional[Tuple[int, int, int]]:
    """(hits, misses, size) of the kernel launch-shape cache kept by
    compile_log: a miss on the serving path is a first launch of a shape
    (the one-time kernel build included), a hit a launch of a known one."""
    from surrealdb_tpu_torch import compile_log

    hits = misses = 0
    for labels, v in counters_matching("compile_cache").items():
        outcome = dict(labels).get("outcome")
        if outcome == "hit":
            hits += int(v)
        elif outcome == "miss":
            misses += int(v)
    return hits, misses, compile_log.size()


def collect_node_metrics(ds=None) -> None:
    """Refresh process/node-level gauges (reference: the runtime metrics
    the OTEL stack exports per node). Called by the /metrics handler right
    before rendering, so scrapes see current values: process RSS, live
    WS sessions (ws_connections gauge, maintained elsewhere), live-query
    subscriptions, jit compile-cache hits/misses, and per-device memory
    when the backend reports it (CPU returns None)."""
    import sys

    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        import os as _os

        gauge_set(
            "process_resident_memory_bytes", rss_pages * _os.sysconf("SC_PAGE_SIZE")
        )
    except (OSError, ValueError, IndexError):
        pass
    if ds is not None and getattr(ds, "notifications", None) is not None:
        gauge_set("live_queries", ds.notifications.live_count())
    # workload statistics plane: how many statement shapes the bounded
    # LRU currently tracks (evictions are the counter next to it)
    try:
        from surrealdb_tpu_torch import stats

        gauge_set("statement_fingerprints", stats.size())
    except Exception:  # noqa: BLE001 — metrics must never fail a scrape
        inc("scrape_section_errors", section="stats")
    # flight recorder: live background-task gauges + per-subsystem memory
    # watermarks for the engine's device-bound mirrors
    try:
        from surrealdb_tpu_torch import bg

        bg.export_gauges()
    except Exception:  # noqa: BLE001 — metrics must never fail a scrape
        inc("scrape_section_errors", section="bg_gauges")
    # network plane: admission queue depths + write-queue backpressure, so
    # a scrape shows where bytes and requests are piling up RIGHT NOW
    try:
        from surrealdb_tpu_torch.net import loop as _netloop
        from surrealdb_tpu_torch.net import qos as _netqos

        nd = _netloop.queue_depths()
        gauge_set("net_open_connections", nd["conns"])
        gauge_set("net_write_queued_bytes", nd["write_queued_bytes"])
        qd = _netqos.queue_depths()
        # aggregate series only (label cardinality stays bounded); the
        # per-tenant breakdown lives in the bundle's `net` section
        gauge_set("net_admission_queued", qd["queued"])
        gauge_set("net_admission_inflight", qd["inflight"])
    except Exception:  # noqa: BLE001 — metrics must never fail a scrape
        inc("scrape_section_errors", section="net")
    if ds is not None:
        try:
            for subsystem, nbytes in mirror_memory_bytes(ds).items():
                gauge_set("mirror_memory_bytes", nbytes, subsystem=subsystem)
        except Exception:  # noqa: BLE001 — metrics must never fail a scrape
            inc("scrape_section_errors", section="mirror_memory")
    jit = _jit_cache_stats()
    if jit is not None:
        hits, misses, size = jit
        gauge_set("jit_cache_hits", hits)
        gauge_set("jit_cache_misses", misses)
        gauge_set("jit_cache_size", size)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                if "allocated_bytes.all.current" in ms:
                    gauge_set(
                        "device_memory_bytes_in_use",
                        ms["allocated_bytes.all.current"],
                        device=str(i),
                    )
        except Exception:  # noqa: BLE001 — metrics must never fail a scrape
            inc("scrape_section_errors", section="device_memory")


def mirror_memory_bytes(ds) -> Dict[str, int]:
    """Host-array bytes held per mirror subsystem (vector matrices, IVF
    list tables, graph CSR arrays, column mirrors) — the per-subsystem
    memory watermark the flight recorder attributes device pressure to.
    Host nbytes bound the device upload size of every mirror (the vector
    mirror uploads these arrays, as bf16 on CUDA by default), so this is
    backend-independent."""
    out = {"vector_mirror": 0, "ivf": 0, "graph_csr": 0, "column_mirror": 0}
    stores = getattr(ds, "index_stores", None)
    if stores is not None:
        with stores._lock:  # noqa: SLF001 — read-only snapshot
            mirrors = list(stores._stores.values())  # noqa: SLF001
        for m in mirrors:
            data = getattr(m, "data", None)
            if data is not None and hasattr(data, "nbytes"):
                out["vector_mirror"] += int(data.nbytes)
            ivf = getattr(m, "ivf", None)
            if ivf is not None:
                cents = getattr(ivf, "centroids", None)
                if cents is not None and hasattr(cents, "nbytes"):
                    out["ivf"] += int(cents.nbytes)
                out["ivf"] += 8 * int(getattr(ivf, "_n", 0) or 0)
    gm = getattr(ds, "graph_mirrors", None)
    if gm is not None:
        with gm._lock:  # noqa: SLF001
            csrs = list(gm._m.values())  # noqa: SLF001
        for c in csrs:
            for arr in (c.indptr, c.indices):
                if arr is not None:
                    out["graph_csr"] += int(arr.nbytes)
    cm = getattr(ds, "column_mirrors", None)
    if cm is not None:
        with cm._lock:  # noqa: SLF001
            cols = list(cm._mirrors.values())  # noqa: SLF001
        for mirror in cols:
            for col in mirror.columns.values():
                out["column_mirror"] += int(col.tags.nbytes) + int(col.nums.nbytes)
    return out


# ------------------------------------------------------------------ exposition
def _esc(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: _LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in labels]
    if extra is not None:
        parts.append(f'{extra[0]}="{_esc(extra[1])}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v: float) -> str:
    return repr(v) if isinstance(v, float) and not v.is_integer() else str(int(v))


def _bucket_label(b: float) -> str:
    return repr(b) if isinstance(b, float) and not float(b).is_integer() else str(int(b))


def export_state() -> dict:
    """Raw registry state for cluster federation (cluster/rpc.py `metrics`
    op): JSON-able — label tuples become dicts, histogram series become
    [family, buckets, labels, cells]. The coordinator re-labels every
    series with node=<id> and renders one merged exposition."""
    with _lock:
        return {
            "counters": [[n, dict(k), v] for (n, k), v in _counters.items()],
            "gauges": [[n, dict(k), v] for (n, k), v in _gauges.items()],
            "hists": [
                [fam, list(buckets), dict(lk), list(h)]
                for fam, (buckets, series) in _hists.items()
                for lk, h in series.items()
            ],
        }


def render_prometheus_federated(states: Dict[str, Optional[dict]]) -> str:
    """One Prometheus exposition for the WHOLE cluster (`/metrics?cluster=1`
    on the coordinator): every member's series re-labeled `node=<id>`
    (Monarch-style region labeling — one scrape, per-node attribution).
    Degraded-tolerant: a member whose scrape failed (state None)
    contributes only `surreal_cluster_scrape_up{node="<id>"} 0`, and the
    scrape still succeeds."""
    counters: Dict[str, List[Tuple[_LabelKey, float]]] = {}
    gauges: Dict[str, List[Tuple[_LabelKey, float]]] = {}
    hists: Dict[str, Tuple[Tuple[float, ...], List[Tuple[_LabelKey, list]]]] = {}
    for node in sorted(states):
        st = states[node]
        gauges.setdefault("cluster_scrape_up", []).append(
            (_key({"node": node}), 0.0 if st is None else 1.0)
        )
        if st is None:
            continue
        for n, labels, v in st.get("counters") or []:
            counters.setdefault(str(n), []).append(
                (_key(dict(labels, node=node)), float(v))
            )
        for n, labels, v in st.get("gauges") or []:
            gauges.setdefault(str(n), []).append(
                (_key(dict(labels, node=node)), float(v))
            )
        for fam, buckets, labels, cells in st.get("hists") or []:
            entry = hists.setdefault(str(fam), (tuple(buckets), []))
            if len(entry[0]) == len(buckets):  # shape-mismatched series drop
                entry[1].append((_key(dict(labels, node=node)), list(cells)))

    lines: List[str] = []
    for name in sorted(counters):
        fam = f"surreal_{name}_total"
        lines.append(f"# TYPE {fam} counter")
        for labels, v in sorted(counters[name]):
            lines.append(f"{fam}{_fmt_labels(labels)} {_num(v)}")
    for name in sorted(gauges):
        fam = f"surreal_{name}"
        lines.append(f"# TYPE {fam} gauge")
        for labels, v in sorted(gauges[name]):
            lines.append(f"{fam}{_fmt_labels(labels)} {_num(v)}")
    for family in sorted(hists):
        buckets, series = hists[family]
        fam = f"surreal_{family}"
        lines.append(f"# TYPE {fam} histogram")
        for labels, h in sorted(series):
            cum = 0
            for i, b in enumerate(buckets):
                cum += h[i]
                lines.append(
                    f"{fam}_bucket{_fmt_labels(labels, ('le', _bucket_label(b)))} {cum}"
                )
            cum += h[len(buckets)]
            lines.append(f"{fam}_bucket{_fmt_labels(labels, ('le', '+Inf'))} {cum}")
            lines.append(f"{fam}_sum{_fmt_labels(labels)} {h[-3]:.6f}")
            lines.append(f"{fam}_count{_fmt_labels(labels)} {h[-2]}")
    return "\n".join(lines) + "\n"


def render_prometheus() -> str:
    """Valid Prometheus text exposition of counters, gauges and histograms
    (reference telemetry/metrics/http/, ws/). Label values are escaped;
    histograms render cumulative `_bucket{le=...}` + `_sum` + `_count`."""
    lines: List[str] = []
    with _lock:
        by_counter: Dict[str, List[Tuple[_LabelKey, float]]] = {}
        for (name, labels), v in _counters.items():
            by_counter.setdefault(name, []).append((labels, v))
        for name in sorted(by_counter):
            fam = f"surreal_{name}_total"
            lines.append(f"# TYPE {fam} counter")
            for labels, v in sorted(by_counter[name]):
                lines.append(f"{fam}{_fmt_labels(labels)} {_num(v)}")

        by_gauge: Dict[str, List[Tuple[_LabelKey, float]]] = {}
        for (name, labels), v in _gauges.items():
            by_gauge.setdefault(name, []).append((labels, v))
        for name in sorted(by_gauge):
            fam = f"surreal_{name}"
            lines.append(f"# TYPE {fam} gauge")
            for labels, v in sorted(by_gauge[name]):
                lines.append(f"{fam}{_fmt_labels(labels)} {_num(v)}")

        for family in sorted(_hists):
            buckets, series = _hists[family]
            fam = f"surreal_{family}"
            lines.append(f"# TYPE {fam} histogram")
            for labels in sorted(series):
                h = series[labels]
                cum = 0
                for i, b in enumerate(buckets):
                    cum += h[i]
                    lines.append(
                        f"{fam}_bucket{_fmt_labels(labels, ('le', _bucket_label(b)))} {cum}"
                    )
                cum += h[len(buckets)]
                lines.append(f"{fam}_bucket{_fmt_labels(labels, ('le', '+Inf'))} {cum}")
                lines.append(f"{fam}_sum{_fmt_labels(labels)} {h[-3]:.6f}")
                lines.append(f"{fam}_count{_fmt_labels(labels)} {h[-2]}")
    return "\n".join(lines) + "\n"
