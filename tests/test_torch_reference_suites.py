"""The reference's own test files, run against the PyTorch port.

One subprocess runs the files below through `tests/torch_reference_hook.py`,
which maps `import surrealdb_tpu[.x]` to `surrealdb_tpu_torch[.x]`, answers
`import jax[.numpy]` with a stub that raises when touched, and defaults the
port's `device` to "cpu" there (never in this process). Each
file is then one case: it must collect, and the set of its cases that fail
must equal its entry in KNOWN_DIFFERENCES, so a case that starts passing
fails the test too and the list can only shrink."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE_FILES = (
    "test_e2e_crud", "test_parser", "test_key_encoding", "test_decimal",
    "test_column_scan", "test_planner_multi", "test_permissions", "test_views",
    "test_external_sort", "test_fnc_methods", "test_retry_savepoint",
    "test_bulk_insert", "test_bulk_ingest_v2", "test_index_builder",
    "test_dispatch", "test_changefeed_gc", "test_scripting", "test_kvs",
    "test_access_bearer", "test_jwt_fns",
    "test_cbor", "test_sdk_server", "test_server_auth", "test_server_middleware",
    "test_net_loop", "test_graphql", "test_capabilities", "test_tracing",
    "test_node_telemetry", "test_telemetry_obs", "test_flight_recorder",
    "test_locks_sanitizer", "test_fuzz", "test_ml", "test_surml",
    "test_ft_mirror", "test_fulltext", "test_ml_batch",
    "test_cluster", "test_cluster_obs", "test_elastic", "test_faults", "test_tombstone_gc",
    "test_accounting", "test_advisor", "test_stats", "test_plan_cache", "test_column_pipeline",
)

# Cases that test the reference's own tooling, not the engine: each loads
# `scripts/` (the bench artifact tools, graftlint) or JAX, which the port
# never imports and the hook's leak check refuses. They are deselected by
# node id; `test_not_run_names_existing_cases` keeps every entry pointing
# at a case that exists.
_BENCH_TOOLS = "loads scripts/ (the reference's bench artifact tools)"
NOT_RUN = {
    "test_flight_recorder": {
        "test_bench_diff_flags_and_names_culprit_phase": _BENCH_TOOLS,
        "test_validator_schema5_rules": _BENCH_TOOLS,
    },
    "test_locks_sanitizer": {
        "test_report_dump_and_lockorder_check": "loads scripts.graftlint (the reference's lint tool)",
    },
    "test_telemetry_obs": {
        "test_bench_artifact_validator": _BENCH_TOOLS,
    },
    "test_surml": {
        "test_onnx_mini_jax_forward": "runs the ONNX graph under jax.jit",
    },
    "test_elastic": {
        "test_cutover_failpoint_leaves_member_on_old_epoch": _BENCH_TOOLS,
    },
    "test_stats": {
        "test_bench_diff_statements_names_flip_culprit": _BENCH_TOOLS,
        "test_drift_proof_end_to_end": _BENCH_TOOLS,
    },
    "test_accounting": {
        "test_bench_diff_tenants_names_share_shift": _BENCH_TOOLS,
    },
    "test_advisor": {
        "test_bench_diff_advisor_names_lifecycle": _BENCH_TOOLS,
    },
}

# The port retries a dispatch batch only on torch.cuda.OutOfMemoryError and
# the fault injector's transient error; these reference cases raise XLA's
# transient marker strings (remote_compile: HTTP 500, UNAVAILABLE,
# RESOURCE_EXHAUSTED) in a plain RuntimeError, which the port treats as
# deterministic. tests/test_torch_dispatch.py holds the same retries (and
# the retry counter on a served /metrics) with the port's transient class.
_RETRY_RULE = "dispatch retries only torch.cuda.OutOfMemoryError, not XLA marker strings"

# The port has no XLA: compile_log names a first launch's span and
# histogram `kernel_compile` (a waiter's `kernel_compile_wait`) where the
# reference says `xla_compile`; the event log and the compile_cache /
# compile_events counters keep the reference's names.
# tests/test_torch_flight_recorder.py holds the same cases with the port's
# names.
_SPAN_NAMES = "first-launch spans are kernel_compile[_wait], not xla_compile[_wait]"

KNOWN_DIFFERENCES = {
    "test_dispatch": {
        "test_transient_runner_failure_retried_once": _RETRY_RULE,
        "test_transient_collect_failure_retried_once": _RETRY_RULE,
        "test_split_retry_bisects_oversized_batch": _RETRY_RULE,
        "test_split_retry_floor_retries_whole": _RETRY_RULE,
        "test_split_retry_deterministic_half_not_reexecuted": _RETRY_RULE,
        "test_collect_phase_transient_failure_split_retried": _RETRY_RULE,
    },
    "test_telemetry_obs": {
        "test_dispatch_transient_retry_counted_by_cause": _RETRY_RULE,
        "test_metrics_and_slow_endpoints_roundtrip": _RETRY_RULE,
    },
    "test_flight_recorder": {
        "test_compile_attributed_to_exactly_one_trace": _SPAN_NAMES,
        "test_concurrent_caller_records_wait_not_phantom_hit": _SPAN_NAMES,
    },
}


@pytest.fixture(scope="module")
def suite_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference_suites")
    xml, leaks = out / "junit.xml", out / "leaks.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TORCH_REFERENCE_HOOK_LEAKS"] = str(leaks)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_reference_hook.py"),
         "-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-m", "not slow",
         "--rootdir", REPO, f"--junitxml={xml}",
         *(a for f, names in NOT_RUN.items() for c in names
           for a in ("--deselect", f"tests/{f}.py::{c}")),
         *(os.path.join(REPO, "tests", f + ".py") for f in REFERENCE_FILES)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(out),
    )
    assert xml.exists(), proc.stdout[-3000:] + proc.stderr[-3000:]
    cases = {f: {} for f in REFERENCE_FILES}
    for tc in ET.parse(xml).getroot().iter("testcase"):
        module = tc.get("classname", "").split(".")
        f = next((m for m in module if m in cases), None)
        if f is None:  # a collection error names its file in `name`
            f = next((m for m in REFERENCE_FILES if m in tc.get("name", "")), "?")
            cases.setdefault(f, {})
        failed = tc.find("failure") is not None or tc.find("error") is not None
        cases[f][tc.get("name")] = "failed" if failed else (
            "skipped" if tc.find("skipped") is not None else "passed")
    return cases, json.loads(leaks.read_text()), proc


@pytest.mark.parametrize("name", REFERENCE_FILES)
def test_reference_file_against_port(suite_run, name):
    cases, _leaks, proc = suite_run
    got = cases[name]
    assert got, f"{name} collected nothing:\n{proc.stdout[-3000:]}"
    assert name not in got, f"{name} failed to collect:\n{proc.stdout[-3000:]}"
    failing = {c for c, state in got.items() if state == "failed"}
    known = set(KNOWN_DIFFERENCES.get(name, {}))
    assert failing == known, (
        f"newly failing: {sorted(failing - known)}; "
        f"listed but passing: {sorted(known - failing)}\n{proc.stdout[-3000:]}"
    )


def test_reference_suites_ran_on_the_port(suite_run):
    """Every `surrealdb_tpu` module the files imported was the port's, and
    nothing of JAX or of the repo's JAX tooling was loaded."""
    _cases, leaks, _proc = suite_run
    assert leaks == {"reference_files": [], "foreign_modules": []}, leaks


def test_not_run_names_existing_cases(suite_run):
    """Each deselected case is a test function of its file that the run
    did not report, so NOT_RUN leaves out exactly what it lists."""
    cases, _leaks, _proc = suite_run
    for f, names in NOT_RUN.items():
        assert f in REFERENCE_FILES, f
        with open(os.path.join(REPO, "tests", f + ".py")) as fh:
            defined = {n.name for n in ast.walk(ast.parse(fh.read()))
                       if isinstance(n, ast.FunctionDef)}
        for c in names:
            assert c in defined, f"{f}::{c} no longer exists"
            assert not any(k == c or k.startswith(c + "[") for k in cases[f]), f"{f}::{c} ran"


def _hook():
    spec = importlib.util.spec_from_file_location(
        "torch_reference_hook", os.path.join(REPO, "tests", "torch_reference_hook.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_leak_check_reports_real_jax_but_not_the_stub():
    """The stub the hook gives for `import jax.numpy` is not a leak, a real
    JAX module still is (this process has real JAX: conftest imports it),
    and touching the stub fails."""
    import jax
    import jax.numpy

    hook = _hook()
    stubs = {"jax": hook.JaxStub("jax"), "jax.numpy": hook.JaxStub("jax.numpy")}
    assert hook.leaks(REPO, stubs) == {"reference_files": [], "foreign_modules": []}
    real = hook.leaks(REPO, {"jax": jax, "jax.numpy": jax.numpy})
    assert real["foreign_modules"] == ["jax", "jax.numpy"]
    assert "jax" in hook.leaks(REPO)["foreign_modules"]
    with pytest.raises(hook.StubTouched, match="has no JAX"):
        stubs["jax.numpy"].zeros((2,))
    with pytest.raises(hook.StubTouched):
        stubs["jax"].jit


def test_stub_is_not_swallowed_as_a_missing_attribute():
    """`hasattr`, a `getattr` default or `except AttributeError` in a
    reference file does not take the stub for a JAX that lacks the name:
    touching it still fails; only a missing dunder is an AttributeError."""
    hook = _hook()
    stub = hook.JaxStub("jax.numpy")
    assert not issubclass(hook.StubTouched, AttributeError)
    with pytest.raises(hook.StubTouched):
        hasattr(stub, "numpy_fn")
    with pytest.raises(hook.StubTouched):
        getattr(stub, "float32", None)
    assert not hasattr(stub, "__wrapped__")


def test_hook_stubs_jax_in_its_subprocess():
    """Under the hook `import jax.numpy` gives the stub (nothing of real
    JAX is loaded), and any use of it raises."""
    code = (
        "import sys; sys.argv = ['hook']; import runpy\n"
        f"hook = runpy.run_path({os.path.join(REPO, 'tests', 'torch_reference_hook.py')!r})\n"
        "hook['install']()\n"
        "import jax.numpy\n"
        "assert isinstance(jax, hook['JaxStub']) and isinstance(jax.numpy, hook['JaxStub'])\n"
        "try:\n    jax.numpy.asarray([1])\nexcept hook['StubTouched']:\n    pass\n"
        "else:\n    raise SystemExit('stub did not raise')\n"
        "assert not [m for m in sys.modules if m.startswith(('jaxlib', 'jax._src'))]\n"
        f"assert hook['leaks']({REPO!r}) == {{'reference_files': [], 'foreign_modules': []}}\n"
        "print('stubbed')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0 and "stubbed" in proc.stdout, proc.stdout + proc.stderr
