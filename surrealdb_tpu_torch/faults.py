"""Deterministic failpoint fault-injection engine.

Role of the reference's `fail::fail_point!` sites (the TiKV/FoundationDB
stacks underneath the reference earn their recovery claims from failpoint
chaos suites): every engine layer that has a RECOVERY STORY carries a named
injection site, and this module decides — deterministically, from a seeded
RNG — whether that site misbehaves on a given pass. A failure path that can
be triggered on demand is a failure path that can be TESTED; everything
else is a comment.

Activation:

- environment: ``SURREAL_FAILPOINTS="site=action[:prob][:count],..."``
  parsed once at first use (the spec string comes through cnf.FAILPOINTS);
- test API: :func:`enable` / :func:`disable` / :func:`reset` /
  :func:`seed` (reproducible chaos schedules).

Actions:

- ``error`` / ``error-<class>`` — raise an injected exception.  Classes:
  ``fault`` (FaultError, a SurrealError — the default), ``transient``
  (message carries ``UNAVAILABLE`` so dispatch classifies it transient and
  split-retries), ``oserror`` (a ConnectionError — the cluster RPC layer
  wraps it into NodeUnavailableError like any network failure), ``kvs``
  (KvsError), ``runtime`` (RuntimeError).
- ``latency-<ms>`` — sleep that long, then continue normally.
- ``corrupt`` — return a corrupted version of the payload the site passed
  to :func:`fire` (bytes are truncated + bit-flipped: the
  peer-died-mid-response shape).
- ``panic`` — raise :class:`FaultPanic`, a BaseException that escapes
  ``except Exception`` guards and kills the executing thread (the
  panic-thread action; bg service supervision is what catches it).

Site catalog (the layers with recovery stories; `bg.<kind>` is a family):

====================== ====================================================
``kvs.commit``          Transaction.commit_direct, before the backend commit
``kvs.group_commit.flush``  GroupCommit._flush, before the drain
``column.delta_apply``  ColumnMirrors.apply_bulk (decline-to-rebuild path)
``vector.delta_apply``  vector-mirror bulk delta application at commit
``dispatch.launch``     the coalesced kernel launch (bisect-retry path)
``cluster.rpc.send``    client request, before the socket write
``cluster.rpc.recv``    client response body (corrupt = truncated CBOR)
``cluster.rpc.handle``  server-side op execution
``cluster.hlc.stamp``   the write-path HLC stamp mint (pre-commit failure)
``cluster.migrate.stream``  one shard-migration batch, before its RPC
``cluster.migrate.cutover`` a member's ring cutover (epoch commit)
``cluster.repair.sweep``    one anti-entropy peer leg, before the digests
``bg.<kind>``           any background task body (bg.run lifecycle)
``cf.gc``               the changefeed GC sweep
====================== ====================================================

Trip counters export as ``failpoint_trips{site,action}`` on /metrics and as
the debug bundle's eighth section (``faults``, bundle.py). The internal
lock is ``faults`` in locks.HIERARCHY — a leaf above the telemetry leaves,
because sites fire while holding commit/dispatch locks.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import KvsError, SurrealError
from surrealdb_tpu_torch.utils import locks as _locks


class FaultError(SurrealError):
    """The default injected failure (a plain engine error)."""


class TransientFaultError(SurrealError):
    """Injected failure that the dispatch layer classifies transient (by
    type) and so exercises its split-retry path."""


class FaultPanic(BaseException):
    """panic-thread action: deliberately NOT an Exception subclass, so the
    ubiquitous `except Exception` guards cannot swallow it — it kills the
    thread it fires on, the way a Rust panic would."""


def _mk_fault(site: str) -> BaseException:
    return FaultError(f"failpoint {site!r} injected error")


def _mk_transient(site: str) -> BaseException:
    return TransientFaultError(
        f"failpoint {site!r} injected transient fault (UNAVAILABLE)"
    )


def _mk_oserror(site: str) -> BaseException:
    return ConnectionError(f"failpoint {site!r} injected connection error")


def _mk_kvs(site: str) -> BaseException:
    return KvsError(f"failpoint {site!r} injected kvs error")


def _mk_runtime(site: str) -> BaseException:
    return RuntimeError(f"failpoint {site!r} injected runtime error")


ERROR_CLASSES = {
    "fault": _mk_fault,
    "transient": _mk_transient,
    "oserror": _mk_oserror,
    "kvs": _mk_kvs,
    "runtime": _mk_runtime,
}


class Failpoint:
    """One armed site's state (guarded by the module lock)."""

    __slots__ = ("site", "action", "arg", "prob", "remaining", "trips")

    def __init__(self, site, action, arg, prob, count):
        self.site = site
        self.action = action  # error | latency | corrupt | panic
        self.arg = arg  # error class key / latency seconds
        self.prob = prob
        self.remaining: Optional[int] = count  # None = unlimited
        self.trips = 0

    def to_dict(self) -> dict:
        return {
            "action": self.action
            + (f"-{self.arg}" if isinstance(self.arg, str) else ""),
            "arg": self.arg,
            "prob": self.prob,
            "remaining": self.remaining,
            "trips": self.trips,
        }


_lock = _locks.Lock("faults")
_sites: Dict[str, Failpoint] = {}
_rng = random.Random()
_seed: Optional[int] = None
_armed = False  # lock-free fast path: no site armed -> fire() is a no-op
_env_loaded = False


class CORRUPT:
    """Sentinel returned by the corrupt action for payloads with no natural
    corruption (None, numbers): unmistakably not a valid value."""


def _parse_action(text: str):
    """'error', 'error-transient', 'latency-50', 'corrupt', 'panic' ->
    (action, arg)."""
    head, _, arg = text.partition("-")
    head = head.strip().lower()
    if head == "error":
        key = (arg or "fault").strip().lower()
        if key not in ERROR_CLASSES:
            raise ValueError(
                f"unknown failpoint error class {key!r} "
                f"(one of {sorted(ERROR_CLASSES)})"
            )
        return "error", key
    if head == "latency":
        try:
            ms = float(arg or 10.0)
        except ValueError as e:
            raise ValueError(f"bad failpoint latency {arg!r}") from e
        return "latency", max(ms, 0.0) / 1000.0
    if head == "corrupt":
        return "corrupt", None
    if head == "panic":
        return "panic", None
    raise ValueError(f"unknown failpoint action {text!r}")


def configure(spec: str) -> None:
    """Arm sites from a spec string: ``site=action[:prob][:count]``,
    comma-separated. Raises ValueError on a malformed spec (a silently
    ignored chaos schedule is worse than none)."""
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        site, sep, rest = part.partition("=")
        if not sep or not site.strip():
            raise ValueError(f"bad failpoint spec {part!r} (want site=action)")
        bits = rest.split(":")
        action, arg = _parse_action(bits[0])
        prob = float(bits[1]) if len(bits) > 1 and bits[1] != "" else 1.0
        count = int(bits[2]) if len(bits) > 2 and bits[2] != "" else None
        enable(site.strip(), bits[0].strip(), prob=prob, count=count,
               _parsed=(action, arg))


def _ensure_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    if cnf.FAILPOINTS:
        configure(cnf.FAILPOINTS)
    if cnf.FAULTS_SEED is not None:
        seed(cnf.FAULTS_SEED)


def enable(
    site: str,
    action: str = "error",
    prob: float = 1.0,
    count: Optional[int] = None,
    _parsed=None,
) -> None:
    """Arm one site (test API). `action` uses the spec grammar
    ('error-transient', 'latency-25', ...)."""
    global _armed
    act, arg = _parsed if _parsed is not None else _parse_action(action)
    with _lock:
        fp = Failpoint(site, act, arg, min(max(prob, 0.0), 1.0), count)
        old = _sites.get(site)
        if old is not None:
            fp.trips = old.trips  # survived trip count stays attributable
        _sites[site] = fp
        _armed = True


def disable(site: str) -> None:
    """Disarm a site; its trip count stays visible in snapshots."""
    with _lock:
        fp = _sites.get(site)
        if fp is not None:
            fp.remaining = 0


def reset() -> None:
    """Drop every site and reseed from nothing (tests)."""
    global _armed, _seed
    with _lock:
        _sites.clear()
        _armed = False
        _seed = None
        _rng.seed()


def seed(n: int) -> None:
    """Seed the trip RNG — the same schedule over the same op sequence
    trips the same sites (reproducible chaos runs)."""
    global _seed
    with _lock:
        _seed = int(n)
        _rng.seed(int(n))


def _corrupt(payload: Any) -> Any:
    if isinstance(payload, (bytes, bytearray)):
        if len(payload) <= 1:
            return b"\xff"
        cut = bytearray(payload[: max(len(payload) // 2, 1)])
        cut[0] ^= 0xFF  # truncated AND mangled: the died-mid-write shape
        return bytes(cut)
    if isinstance(payload, str):
        return payload[: len(payload) // 2] + "\x00"
    if isinstance(payload, list):
        return payload[: len(payload) // 2]
    if isinstance(payload, dict):
        out = dict(payload)
        out["__corrupt__"] = True
        return out
    return CORRUPT


def fire(site: str, payload: Any = None) -> Any:
    """The injection hook every site calls. Unarmed sites cost one module
    attribute read. Armed sites roll the seeded RNG under the `faults`
    lock, then act: raise (error/panic), sleep (latency), or return a
    corrupted payload (corrupt). Returns `payload` untouched otherwise."""
    if not _armed and _env_loaded:
        return payload
    _ensure_env()
    if not _armed:
        return payload
    with _lock:
        fp = _sites.get(site)
        if fp is None or fp.remaining == 0:
            return payload
        if fp.prob < 1.0 and _rng.random() >= fp.prob:
            return payload
        if fp.remaining is not None:
            fp.remaining -= 1
        fp.trips += 1
        action, arg = fp.action, fp.arg
    from surrealdb_tpu_torch import events, telemetry

    telemetry.inc("failpoint_trips", site=site, action=action)
    # timeline entry: a trip observed while serving a statement joins that
    # statement's trace — chaos runs read injected faults next to their
    # victims instead of diffing counters
    events.emit("fault.trip", site=site, action=action)
    if action == "error":
        raise ERROR_CLASSES[arg](site)
    if action == "latency":
        time.sleep(arg)
        return payload
    if action == "corrupt":
        return _corrupt(payload)
    if action == "panic":
        raise FaultPanic(f"failpoint {site!r} panic")
    return payload


def snapshot() -> dict:
    """The engine's failpoint state — the debug bundle's eighth section:
    armed sites, per-site trip counters, the seed that produced them."""
    _ensure_env()
    with _lock:
        return {
            "enabled": _armed,
            "seed": _seed,
            "sites": {name: fp.to_dict() for name, fp in sorted(_sites.items())},
            "trips_total": sum(fp.trips for fp in _sites.values()),
        }
