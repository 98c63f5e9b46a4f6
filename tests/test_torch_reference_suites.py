"""The reference's own test files, run against the PyTorch port.

One subprocess runs the files below through `tests/torch_reference_hook.py`,
which maps `import surrealdb_tpu[.x]` to `surrealdb_tpu_torch[.x]` and
defaults the port's `device` to "cpu" there (never in this process). Each
file is then one case: it must collect, and the set of its cases that fail
must equal its entry in KNOWN_DIFFERENCES, so a case that starts passing
fails the test too and the list can only shrink."""

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
)

# The port retries a dispatch batch only on torch.cuda.OutOfMemoryError and
# the fault injector's transient error; these reference cases raise XLA's
# transient marker strings (remote_compile: HTTP 500, UNAVAILABLE,
# RESOURCE_EXHAUSTED) in a plain RuntimeError, which the port treats as
# deterministic. tests/test_torch_dispatch.py holds the same retries with the
# port's transient class.
_RETRY_RULE = "dispatch retries only torch.cuda.OutOfMemoryError, not XLA marker strings"

KNOWN_DIFFERENCES = {
    "test_dispatch": {
        "test_transient_runner_failure_retried_once": _RETRY_RULE,
        "test_transient_collect_failure_retried_once": _RETRY_RULE,
        "test_split_retry_bisects_oversized_batch": _RETRY_RULE,
        "test_split_retry_floor_retries_whole": _RETRY_RULE,
        "test_split_retry_deterministic_half_not_reexecuted": _RETRY_RULE,
        "test_collect_phase_transient_failure_split_retried": _RETRY_RULE,
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
