"""Per-tenant weighted-fair admission control (the C1M QoS plane).

The r10 admission story was one global semaphore on the cluster
coordinator (cluster/executor.py): overload degraded to bounded latency,
but one tenant's pathological statement shape throttled the NODE, not
the tenant. This plane promotes admission to the ingress and keys it by
tenant `(ns, db)`:

- every tenant gets a **token bucket** (`SURREAL_NET_TENANT_RATE`
  tokens/s refill into a `SURREAL_NET_TENANT_BURST` bucket; rate 0
  disables rate limiting) and an **in-flight quota**
  (`SURREAL_NET_TENANT_INFLIGHT` concurrently-executing requests);
- past either bound a request is QUEUED (`net.throttle`, counted) up to
  `SURREAL_NET_ADMIT_QUEUE` entries per tenant, then SHED
  (`net.admission_shed`, counted) — overload is a bounded queue and a
  clean refusal, never collapse;
- queued work drains **weighted-fair** (start-time fair queueing): each
  tenant carries a virtual clock; dispatching a request advances it by
  `cost / weight`, and the scheduler always serves the eligible tenant
  with the SMALLEST virtual time. `cost` is the r16 per-fingerprint p99
  estimate (stats.py); `weight` derives from the r17 accounting meters
  (accounting.py) — a tenant consuming more than its fair share of
  `exec_s` earns a proportionally smaller weight (clamped to
  [0.25, 4.0]), so an expensive statement shape throttles ITS tenant
  while cheap tenants sail past it in the same queue structure.

Internal cluster RPCs ride a DEDICATED class (`cls="internal"`) with its
own in-flight bound (`SURREAL_NET_INTERNAL_INFLIGHT`) and FIFO queue:
scatter traffic can never be starved by tenant queues, and tenants can
never consume internal slots.

Lock discipline: `net.qos` is leaf-style — decisions happen under the
lock; admitted callbacks, events and counters fire AFTER release (events
and telemetry are lower hierarchy levels and must never nest inside).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.utils import locks as _locks

INTERNAL = "internal"  # the cluster-channel QoS class


class Shed(Exception):
    """Request refused by admission control (bounded-queue overflow or a
    closed server); the transport answers 503 and the client may retry."""

    def __init__(self, reason: str, ns: str = "", db: str = ""):
        super().__init__(
            f"admission control shed request ({reason}) for tenant "
            f"({ns or '-'}, {db or '-'}) — server overloaded, retry later"
        )
        self.reason = reason
        self.ns, self.db = ns, db


class _Tenant:
    __slots__ = (
        "key", "tokens", "last_refill", "inflight", "queue", "vtime",
        "last_start", "admitted", "shed", "throttled",
    )

    def __init__(self, key: Tuple[str, str], now: float):
        self.key = key
        self.tokens = max(cnf.NET_TENANT_BURST, 1.0)
        self.last_refill = now
        self.inflight = 0
        # (fingerprint, cost_ms, on_admit, enqueue_t)
        self.queue: Deque[tuple] = deque()
        self.vtime = 0.0
        self.last_start = 0.0
        self.admitted = 0
        self.shed = 0
        self.throttled = 0


_lock = _locks.Lock("net.qos")
_tenants: Dict[Tuple[str, str], _Tenant] = {}
_internal_inflight = 0
_internal_queue: Deque[tuple] = deque()
_vclock = 0.0  # floor for new/idle tenants so they can't replay the past
_totals = {"admitted": 0, "shed": 0, "throttled": 0}


def _key(ns: Optional[str], db: Optional[str]) -> Tuple[str, str]:
    return (ns or "", db or "")


# ------------------------------------------------------------------ inputs
def cost_estimate_ms(fingerprint: Optional[str]) -> float:
    """The r16 plane's per-shape cost estimate: the fingerprint's p99 (its
    tail is what a scheduler must budget for), falling back to the mean
    and then to one quantum for never-seen shapes."""
    floor = max(cnf.NET_QOS_QUANTUM_MS, 0.1)
    if not fingerprint:
        return floor
    from surrealdb_tpu_torch import stats

    d = stats.get(fingerprint)
    if not d:
        return floor
    est = d.get("p99_ms") or d.get("mean_ms")
    return max(float(est), floor) if est else floor


def tenant_weight(ns: Optional[str], db: Optional[str]) -> float:
    """The r17 plane's fairness input: `fair_share / tenant_exec_s`,
    clamped to [0.25, 4.0]. A tenant burning 4x the per-tenant fair share
    of engine seconds earns a quarter-weight queue; an idle one at most
    4x. Tenants with no history (or an empty store) weigh 1.0."""
    from surrealdb_tpu_torch import accounting

    e = accounting.get(ns, db)
    if e is None:
        return 1.0
    t_exec = float(e.get("exec_s") or 0.0)
    if t_exec <= 0.0:
        return 1.0
    total = float(accounting.global_totals().get("exec_s") or 0.0)
    n = max(accounting.size(), 1)
    fair = total / n
    if fair <= 0.0:
        return 1.0
    return min(max(fair / t_exec, 0.25), 4.0)


# ------------------------------------------------------------------ engine
def _refill(t: _Tenant, now: float) -> None:
    rate = cnf.NET_TENANT_RATE
    if rate <= 0:
        return
    burst = max(cnf.NET_TENANT_BURST, 1.0)
    t.tokens = min(burst, t.tokens + (now - t.last_refill) * rate)
    t.last_refill = now


def _eligible(t: _Tenant, now: float) -> bool:
    if not t.queue:
        return False
    if t.inflight >= max(cnf.NET_TENANT_INFLIGHT, 1):
        return False
    _refill(t, now)
    return cnf.NET_TENANT_RATE <= 0 or t.tokens >= 1.0


def _drain_locked(now: float) -> List[tuple]:
    """Dispatch everything admittable; returns [(on_admit, wait_s), ...]
    to invoke after the lock is released."""
    global _internal_inflight, _vclock
    out: List[tuple] = []
    # internal class first: dedicated slots, plain FIFO, never starved
    while (
        _internal_queue
        and _internal_inflight < max(cnf.NET_INTERNAL_INFLIGHT, 1)
    ):
        _fp, _cost, on_admit, t0 = _internal_queue.popleft()
        _internal_inflight += 1
        _totals["admitted"] += 1
        out.append((on_admit, now - t0))
    # tenant classes: start-time fair queueing over the eligible set
    while True:
        best: Optional[_Tenant] = None
        for t in _tenants.values():
            if _eligible(t, now) and (best is None or t.vtime < best.vtime):
                best = t
        if best is None:
            break
        fp, cost_ms, on_admit, t0, weight = best.queue.popleft()
        best.inflight += 1
        if cnf.NET_TENANT_RATE > 0:
            best.tokens -= 1.0
        # the virtual clock advance IS the weighting: cost from the r16
        # stats plane, weight from the r17 accounting plane
        best.last_start = max(best.vtime, _vclock)
        best.vtime = best.last_start + cost_ms / max(weight, 1e-6)
        best.admitted += 1
        _totals["admitted"] += 1
        out.append((on_admit, now - t0))
    # advance the floor to the smallest busy START tag (not finish tag: a
    # heavy admit's finish is far in the future, and a floor taken from it
    # would charge newly-arriving tenants for work they never submitted)
    busy = [t.last_start for t in _tenants.values() if t.queue or t.inflight]
    if busy:
        _vclock = max(_vclock, min(busy))
    return out


def _fire(admitted: List[tuple]) -> None:
    from surrealdb_tpu_torch import telemetry

    for on_admit, wait_s in admitted:
        if wait_s > 1e-4:
            telemetry.observe("net_admission_wait", wait_s)
        on_admit()


def submit(
    ns: Optional[str],
    db: Optional[str],
    on_admit: Callable[[], None],
    *,
    fingerprint: Optional[str] = None,
    cls: str = "tenant",
) -> None:
    """Admit-or-queue `on_admit` for tenant `(ns, db)`. The callback runs
    synchronously when a slot is free NOW, else later from whichever
    thread releases the unblocking slot (or from poll()). Raises Shed
    when the tenant's bounded queue is full; the caller answers 503."""
    from surrealdb_tpu_torch import events, telemetry

    if not cnf.NET_QOS:
        on_admit()
        return
    now = time.monotonic()
    key = _key(ns, db)
    throttled = False
    with _lock:
        if cls == INTERNAL:
            if len(_internal_queue) >= 4 * max(cnf.NET_ADMIT_QUEUE, 1):
                _totals["shed"] += 1
                shed = Shed("internal queue full", *key)
            else:
                _internal_queue.append((fingerprint, 0.0, on_admit, now))
                shed = None
        else:
            t = _tenants.get(key)
            if t is None:
                t = _tenants[key] = _Tenant(key, now)
                t.vtime = t.last_start = _vclock
            if len(t.queue) >= max(cnf.NET_ADMIT_QUEUE, 1):
                t.shed += 1
                _totals["shed"] += 1
                shed = Shed("tenant queue full", *key)
            else:
                shed = None
                cost = cost_estimate_ms(fingerprint)
                weight = tenant_weight(ns, db)
                busy = (
                    t.inflight >= max(cnf.NET_TENANT_INFLIGHT, 1)
                    or (cnf.NET_TENANT_RATE > 0 and t.tokens < 1.0)
                )
                t.queue.append((fingerprint, cost, on_admit, now, weight))
                if busy:
                    t.throttled += 1
                    _totals["throttled"] += 1
                    throttled = True
        admitted = [] if shed else _drain_locked(now)
    # lock released: now the observability (events/telemetry are LOWER
    # hierarchy levels) and the admitted callbacks
    if shed is not None:
        telemetry.inc("net_admission_shed", ns=key[0] or "-", cls=cls)
        events.emit(
            "net.admission_shed",
            ns=key[0], db=key[1], fingerprint=fingerprint or "",
            cls=cls, reason=shed.reason,
        )
        raise shed
    if throttled:
        telemetry.inc("net_throttled", ns=key[0] or "-")
        events.emit(
            "net.throttle",
            ns=key[0], db=key[1], fingerprint=fingerprint or "",
            reason="quota",
        )
    _fire(admitted)


def release(ns: Optional[str], db: Optional[str], *, cls: str = "tenant") -> None:
    """A request finished: free its slot and drain whatever that unblocks."""
    global _internal_inflight
    if not cnf.NET_QOS:
        return
    now = time.monotonic()
    with _lock:
        if cls == INTERNAL:
            _internal_inflight = max(_internal_inflight - 1, 0)
        else:
            t = _tenants.get(_key(ns, db))
            if t is not None:
                t.inflight = max(t.inflight - 1, 0)
        admitted = _drain_locked(now)
    _fire(admitted)


def poll() -> None:
    """Time-based drain: token buckets refill on the clock, not on
    completions — the event loop (and blocking waiters) call this so
    rate-limited queues drain without needing a release() edge."""
    if not cnf.NET_QOS:
        return
    with _lock:
        admitted = _drain_locked(time.monotonic())
    _fire(admitted)


def acquire(
    ns: Optional[str],
    db: Optional[str],
    *,
    fingerprint: Optional[str] = None,
    cls: str = "tenant",
    timeout: Optional[float] = None,
) -> bool:
    """Blocking admission for thread-per-connection ingress: returns True
    once admitted (caller MUST release()), raises Shed on queue overflow,
    returns False on timeout (the entry is abandoned — its on_admit
    no-ops)."""
    if not cnf.NET_QOS:
        return True
    got = threading.Event()
    state = {"abandoned": False}

    def on_admit():
        if state["abandoned"]:
            # timed-out waiter: hand the slot straight back
            release(ns, db, cls=cls)
            return
        got.set()

    submit(ns, db, on_admit, fingerprint=fingerprint, cls=cls)
    deadline = None if timeout is None else time.monotonic() + timeout
    while not got.is_set():
        poll()
        wait = 0.02
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                state["abandoned"] = True
                # re-check: admission may have raced the flag
                if got.is_set():
                    return True
                return False
            wait = min(wait, left)
        got.wait(wait)
    return True


# ------------------------------------------------------------------ views
def snapshot(limit: int = 20) -> dict:
    """The bundle `net.qos` half: totals, internal class, worst tenants."""
    with _lock:
        tenants = [
            {
                "ns": t.key[0], "db": t.key[1],
                "inflight": t.inflight, "queued": len(t.queue),
                "admitted": t.admitted, "shed": t.shed,
                "throttled": t.throttled,
                "vtime_ms": round(t.vtime, 3),
                "tokens": round(t.tokens, 2),
            }
            for t in _tenants.values()
        ]
        internal = {
            "inflight": _internal_inflight, "queued": len(_internal_queue),
        }
        totals = dict(_totals)
    tenants.sort(key=lambda e: (-(e["shed"] + e["throttled"]), e["ns"], e["db"]))
    return {
        "enabled": bool(cnf.NET_QOS),
        "totals": totals,
        "internal": internal,
        "tenants": len(tenants),
        "top": tenants[: max(int(limit), 1)],
    }


def queue_depths() -> Dict[str, int]:
    """Scrape-time gauges (telemetry.collect_node_metrics)."""
    with _lock:
        queued = sum(len(t.queue) for t in _tenants.values())
        inflight = sum(t.inflight for t in _tenants.values())
        return {
            "queued": queued + len(_internal_queue),
            "inflight": inflight + _internal_inflight,
        }


def reset() -> None:
    """Drop all admission state (tests / bench windows)."""
    global _internal_inflight, _vclock
    with _lock:
        _tenants.clear()
        _internal_queue.clear()
        _internal_inflight = 0
        _vclock = 0.0
        for k in _totals:
            _totals[k] = 0
