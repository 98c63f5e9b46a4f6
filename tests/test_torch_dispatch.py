"""The port's dispatch retry rule, held to the reference's retry and
split-retry cases (tests/test_dispatch.py) with the port's transient
class. The reference retries on XLA's transient markers (remote compile
500s, RESOURCE_EXHAUSTED, UNAVAILABLE); the port retries only on
`torch.cuda.OutOfMemoryError` and the fault injector's transient error, so
each twin raises the card's out-of-memory error where its reference case
raises a marker string, and checks the same bisected retry (and, for
tests/test_telemetry_obs.py's two retry cases, the cause label on a
served /metrics)."""

import re
import threading
import time

import pytest
import torch

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.dbs.dispatch import DispatchQueue


# one exposition sample, name{labels} value, and a TYPE line, as
# tests/test_telemetry_obs.py checks them
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\[\\\"n])*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\[\\\"n])*\")*\})?"
    r" (?:[0-9.eE+-]+|\+Inf|-Inf|NaN)$"
)
_TYPE_RE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$")


def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB"):
    return torch.cuda.OutOfMemoryError(msg)


def test_transient_runner_failure_retried_once():
    q = DispatchQueue()
    calls = {"n": 0}

    def runner(payloads):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _oom()
        return [p * 10 for p in payloads]

    assert q.submit("k", 4, runner) == 40
    assert calls["n"] == 2
    assert q.stats()["retries"] == 1


def test_transient_collect_failure_retried_once():
    q = DispatchQueue()
    calls = {"n": 0}

    def runner(payloads):
        calls["n"] += 1
        if calls["n"] == 1:
            def bad_collect():
                raise _oom()
            return bad_collect
        return [p + 1 for p in payloads]

    assert q.submit("k", 5, runner) == 6
    assert calls["n"] == 2


class OutOfMemoryRunner:
    """A card with a hard batch-width capacity: any launch wider than `cap`
    fails with the allocator's out-of-memory error. Records every
    attempted launch width."""

    def __init__(self, cap: int, mul: int = 10):
        self.cap = cap
        self.mul = mul
        self.launches: list = []
        self._lock = threading.Lock()

    def __call__(self, payloads):
        with self._lock:
            self.launches.append(len(payloads))
        if len(payloads) > self.cap:
            raise _oom()
        return [p * self.mul for p in payloads]


def _coalesce_batch(q, n, runner, key="k"):
    """Build one n-wide coalesced batch behind a blocked width-1 leader;
    returns ({i: result}, {i: error}) for riders 1..n."""
    release, started = threading.Event(), threading.Event()

    def slow_ok(xs):
        started.set()
        release.wait(5)
        return [("lead", x) for x in xs]

    results, errors = {}, {}

    def submit(i, r):
        try:
            results[i] = q.submit(key, i, r)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    lead = threading.Thread(target=submit, args=(0, slow_ok))
    lead.start()
    assert started.wait(5)
    riders = [threading.Thread(target=submit, args=(i, runner)) for i in range(1, n + 1)]
    for t in riders:
        t.start()
    while q.stats()["submitted"] < n + 1:
        time.sleep(0.005)
    release.set()
    lead.join(10)
    for t in riders:
        t.join(10)
    assert results.pop(0) == ("lead", 0)
    return results, errors


@pytest.fixture()
def no_backoff(monkeypatch):
    monkeypatch.setattr(cnf, "DISPATCH_RETRY_BACKOFF_SECS", 0.0)


def test_split_retry_bisects_oversized_batch(no_backoff):
    """An out-of-memory full batch is bisected down to widths the card can
    serve, never re-executed at the width that just failed, and every rider
    ends with its own result."""
    q = DispatchQueue(split_floor=1, pipeline_depth=1)
    fake = OutOfMemoryRunner(cap=2)
    results, errors = _coalesce_batch(q, 8, fake)

    assert errors == {}
    assert results == {i: i * 10 for i in range(1, 9)}
    assert len([w for w in fake.launches if w == 8]) == 1, fake.launches
    assert sorted(fake.launches) == [2, 2, 2, 2, 4, 4, 8]
    st = q.stats()
    assert st["splits"] == 3  # 8 -> 4+4 -> (2+2)x2
    assert st["failures"] == 0


def test_split_retry_floor_retries_whole(no_backoff):
    """At or below the split floor an out-of-memory batch retries whole,
    once."""
    q = DispatchQueue(split_floor=8, pipeline_depth=1)
    calls = {"n": 0}

    def flaky(payloads):
        calls["n"] += 1
        if calls["n"] == 1 and len(payloads) > 1:
            raise _oom()
        return [p * 10 for p in payloads]

    results, errors = _coalesce_batch(q, 6, flaky)
    assert errors == {} and results == {i: i * 10 for i in range(1, 7)}
    st = q.stats()
    assert st["splits"] == 0 and st["retries"] == 1


def test_split_retry_deterministic_half_not_reexecuted(no_backoff):
    """During a split-retry, a half that fails deterministically fails its
    own riders at once; the other half still succeeds."""
    q = DispatchQueue(split_floor=1, pipeline_depth=1)
    widths = []

    def runner(payloads):
        widths.append(len(payloads))
        if len(payloads) == 4:
            raise _oom()
        if any(p == 1 for p in payloads):
            raise RuntimeError("knn_select: CUDA launch failed with error 9")
        return [p * 10 for p in payloads]

    results, errors = _coalesce_batch(q, 4, runner)
    assert results == {3: 30, 4: 40}
    assert set(errors) == {1, 2}
    assert all("launch failed" in str(e) for e in errors.values())
    assert widths.count(4) == 1  # the failed width never re-ran
    st = q.stats()
    assert st["splits"] == 1 and st["failures"] == 1


def test_collect_phase_transient_failure_split_retried(no_backoff):
    """An out-of-memory error in the collect phase of a wide two-phase
    batch goes through the same bisection as a launch failure."""
    q = DispatchQueue(split_floor=1, pipeline_depth=1)
    state = {"first": True}

    def runner(payloads):
        if state["first"] and len(payloads) == 4:
            state["first"] = False

            def bad_collect():
                raise _oom()

            return bad_collect
        return [p * 10 for p in payloads]

    results, errors = _coalesce_batch(q, 4, runner)
    assert errors == {} and results == {i: i * 10 for i in range(1, 5)}
    assert q.stats()["splits"] == 1


def test_dispatch_transient_retry_counted_by_cause():
    """tests/test_telemetry_obs.py's case: the retry is counted under its
    cause, which the port labels by the exception class."""
    from surrealdb_tpu_torch import telemetry

    telemetry.reset()
    q = DispatchQueue()
    calls = {"n": 0}

    def flaky(payloads):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _oom()
        return [p * 2 for p in payloads]

    assert q.submit("k", 21, flaky) == 42
    st = q.stats()
    assert st["retries"] == 1 and st["failures"] == 0
    assert telemetry.get_counter("dispatch_retries", cause="OutOfMemoryError") == 1
    text = telemetry.render_prometheus()
    assert 'surreal_dispatch_retries_total{cause="OutOfMemoryError"} 1' in text


def test_metrics_and_slow_endpoints_roundtrip(monkeypatch):
    """tests/test_telemetry_obs.py's case on the port's server: one scrape
    of /metrics shows the batch sizes, the cause-labelled retry, the
    unknown RPC method and the statement durations; /slow lists the
    CREATE."""
    import http.client
    import json

    from surrealdb_tpu_torch import telemetry
    from surrealdb_tpu_torch.net.server import serve

    monkeypatch.setattr(cnf, "SLOW_QUERY_THRESHOLD_SECS", 0.0)
    telemetry.reset()
    q = DispatchQueue()
    calls = {"n": 0}

    def flaky(ps):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _oom()
        return list(ps)

    q.submit("k", 1, flaky)
    srv = serve("memory", port=0, auth_enabled=False, device="cpu").start_background()
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port)
        hdrs = {"surreal-ns": "t", "surreal-db": "t"}
        conn.request("POST", "/sql", "CREATE m:1 SET v = 2; SELECT * FROM m;", hdrs)
        r = conn.getresponse()
        r.read()
        assert r.status == 200
        conn.request("POST", "/rpc", json.dumps({"method": "nosuch", "params": []}),
                     {**hdrs, "Content-Type": "application/json"})
        conn.getresponse().read()
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        text = r.read().decode()
        assert r.status == 200
        for line in text.rstrip("\n").split("\n"):
            assert _TYPE_RE.match(line) or _SAMPLE_RE.match(line), line
        assert "surreal_dispatch_batch_size_bucket" in text
        assert 'surreal_dispatch_retries_total{cause="OutOfMemoryError"} 1' in text
        assert re.search(r'surreal_rpc_errors_total\{.*method="_unknown".*\} 1', text)
        for kind in ("CreateStatement", "SelectStatement"):
            assert re.search(r'surreal_statement_duration_seconds_bucket\{kind="%s",le="\+Inf"\} \d+'
                             % kind, text)
        conn.request("GET", "/slow")
        r = conn.getresponse()
        slow = json.loads(r.read())
        assert r.status == 200 and isinstance(slow, list) and slow
        assert any(e["kind"] == "CreateStatement" and e["error"] is None for e in slow)
        conn.close()
    finally:
        srv.shutdown()
        srv.httpd.RequestHandlerClass.ds.close()
