"""The flight recorder's parts that the port names or fills in its own
way, held as tests/test_flight_recorder.py holds the reference's:

- compile_log's first-launch attribution, whose span is `kernel_compile`
  (a waiter's `kernel_compile_wait`) where the reference's is
  `xla_compile`: the same two cases with the port's names;
- bundle.py's `kernel_audit` and `flow_audit` sections, which the port
  always reports unavailable (they audit the JAX package), and its `net`
  section, which lists the live event-loop servers."""

import threading
import time

import pytest

from surrealdb_tpu_torch import bg, cnf, compile_log, telemetry, tracing
from surrealdb_tpu_torch.bundle import debug_bundle


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    tracing.store_reset()
    bg.reset()
    compile_log.reset()
    yield
    bg.reset()
    compile_log.reset()
    tracing.store_reset()


def test_compile_attributed_to_exactly_one_trace(monkeypatch):
    """An unwarmed shape queried concurrently: the first launch lands as
    a `kernel_compile` span in exactly ONE trace; riders see a cache hit."""
    monkeypatch.setattr(cnf, "TRACE_SAMPLE", 1.0)
    from surrealdb_tpu_torch.dbs.dispatch import DispatchQueue

    q = DispatchQueue(max_width=8)
    shape = ("testk", 8, 128)

    def runner(payloads):
        with compile_log.tracked("test", shape):
            time.sleep(0.01)
        return [p * 2 for p in payloads]

    n = 4
    barrier = threading.Barrier(n)
    results = {}

    def client(i):
        with tracing.request(f"knn_req_{i}"):
            barrier.wait()
            results[i] = q.submit("bucket", i, runner)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert results == {i: i * 2 for i in range(n)}
    docs = [tracing.get_trace(t) for t in tracing.trace_ids()]
    with_compile = [
        d for d in docs if any(s["name"] == "kernel_compile" for s in d["spans"])
    ]
    assert len(with_compile) == 1  # exactly one owner
    evs = compile_log.events()
    assert len(evs) == 1 and evs[0]["mode"] == "on_demand"
    assert evs[0]["trace_id"] == with_compile[0]["trace_id"]
    # a later rider through the same shape is a recorded cache hit
    with tracing.request("rider"):
        q.submit("bucket", 9, runner)
    assert (
        telemetry.get_counter(
            "compile_cache", subsystem="test", shape="testkx8x128", outcome="hit"
        )
        >= 1
    )
    assert len(compile_log.events()) == 1  # still one compile


def test_concurrent_caller_records_wait_not_phantom_hit(monkeypatch):
    """A caller racing an in-flight first compile blocks behind the first
    launch: that must surface as an attributed wait, not a hit."""
    monkeypatch.setattr(cnf, "TRACE_SAMPLE", 1.0)
    shape = ("race", 8, 64)
    entered = threading.Event()
    release = threading.Event()

    def winner():
        with compile_log.tracked("knn_exact", shape, prewarmed=True):
            entered.set()
            release.wait(10)

    th = threading.Thread(target=winner)
    th.start()
    assert entered.wait(5)
    done = []

    def loser():
        with tracing.request("blocked_query"):
            with compile_log.tracked("knn_exact", shape):
                pass  # in reality this would wait on the kernel build
            done.append(True)

    th2 = threading.Thread(target=loser)
    th2.start()
    th2.join(5)
    release.set()
    th.join(5)
    assert done
    assert (
        telemetry.get_counter(
            "compile_cache", subsystem="knn_exact", shape="racex8x64", outcome="wait"
        )
        == 1
    )
    # the wait landed in the blocked query's trace; only ONE compile event
    doc = next(
        d
        for t in tracing.trace_ids()
        for d in (tracing.get_trace(t),)
        if d and d["name"] == "blocked_query"
    )
    assert any(s["name"] == "kernel_compile_wait" for s in doc["spans"])
    assert len(compile_log.events()) == 1
    # once the compile has LANDED, later callers are plain hits
    with compile_log.tracked("knn_exact", shape):
        pass
    assert (
        telemetry.get_counter(
            "compile_cache", subsystem="knn_exact", shape="racex8x64", outcome="hit"
        )
        == 1
    )


def test_audit_sections_unavailable_and_net_lists_live_servers():
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.sdk import Surreal

    srv = serve("memory", port=0, auth_enabled=False, device="cpu").start_background()
    ds = srv.httpd.RequestHandlerClass.ds
    try:
        with Surreal(srv.url) as db:
            db.use("t", "t")
            assert db.query("RETURN 1")[0]["result"] == 1
        b = debug_bundle(ds)
        for sec in ("kernel_audit", "flow_audit"):
            assert b[sec]["available"] is False, b[sec]
            assert "JAX package" in b[sec]["reason"], b[sec]
        net = b["net"]
        assert net["enabled"] is True, net
        mine = [s for s in net["servers"] if s["port"] == srv.port]
        assert len(mine) == 1 and mine[0]["host"] == srv.host, net
        assert mine[0]["loops"] >= 1 and mine[0]["accept_to_first_byte"]["samples"] >= 1, net
    finally:
        srv.shutdown()
        ds.close()
    # a shut-down server leaves the section
    assert all(s["port"] != srv.port for s in debug_bundle(None)["net"]["servers"])
