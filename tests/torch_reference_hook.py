"""Run the reference package's own test files against the PyTorch port.

Imported only by the subprocess that `test_torch_reference_suites.py`
starts (never by the suite's own process): it installs a `sys.meta_path`
finder that answers `import surrealdb_tpu[.x]` with the already-imported
`surrealdb_tpu_torch[.x]` module, so the reference's tests drive the
port's objects. The port's entry points default to `device="cuda"`; here
`Datastore`, `IvfState.train`, `_kmeans` and `_full_assign` are wrapped
to default to `"cpu"`, the way the port's own CPU tests pass it. The port
itself gains no knob.

    python tests/torch_reference_hook.py --junitxml=OUT tests/test_kvs.py ...

runs pytest with the repo's `tests/conftest.py` left out (it imports JAX
and primes the reference's tooling) and its `ds` fixture supplied here.
With TORCH_REFERENCE_HOOK_LEAKS=PATH set, it writes to PATH (JSON) any
module of the reference package, JAX or `scripts/` that the run loaded.
"""

import functools
import importlib
import importlib.abc
import importlib.util
import inspect
import json
import os
import sys

import pytest

REF, PORT = "surrealdb_tpu", "surrealdb_tpu_torch"


class _AliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        return None  # a placeholder module, replaced in exec_module

    def exec_module(self, module):
        name = module.__name__
        # importlib returns whatever sys.modules holds under the name after
        # exec_module, so the alias is the port's module object itself
        sys.modules[name] = importlib.import_module(PORT + name[len(REF):])


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname != REF and not fullname.startswith(REF + "."):
            return None
        port_name = PORT + fullname[len(REF):]
        if importlib.util.find_spec(port_name) is None:
            return None  # a module the port lacks: ModuleNotFoundError
        return importlib.util.spec_from_loader(fullname, _AliasLoader())


def _default_cpu(fn):
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        bound = sig.bind_partial(*args, **kwargs)
        if "device" not in bound.arguments:
            kwargs["device"] = "cpu"
        return fn(*args, **kwargs)

    return wrapped


def install() -> None:
    sys.meta_path.insert(0, _AliasFinder())
    from surrealdb_tpu_torch.idx import ivf
    from surrealdb_tpu_torch.kvs.ds import Datastore

    Datastore.__init__ = _default_cpu(Datastore.__init__)
    ivf.IvfState.train = staticmethod(_default_cpu(ivf.IvfState.train))
    ivf._kmeans = _default_cpu(ivf._kmeans)
    ivf._full_assign = _default_cpu(ivf._full_assign)


class _Fixtures:
    """The `ds` fixture of tests/conftest.py, whose module is left out."""

    @pytest.fixture()
    def ds(self):
        from surrealdb_tpu.kvs.ds import Datastore

        return Datastore("memory")


def leaks(repo: str) -> dict:
    """What a run loaded that it should not have: a module file of the
    reference package, or anything of JAX or of the repo's `scripts/`."""
    ref_dir = os.path.join(repo, REF) + os.sep
    files, foreign = set(), set()
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None) or ""
        if f.startswith(ref_dir):
            files.add(os.path.relpath(f, repo))
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "scripts"):
            foreign.add(name)
    return {"reference_files": sorted(files), "foreign_modules": sorted(foreign)}


if __name__ == "__main__":
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    install()
    rc = pytest.main(["--noconftest", *sys.argv[1:]], plugins=[_Fixtures()])
    out = os.environ.get("TORCH_REFERENCE_HOOK_LEAKS")
    if out:
        with open(out, "w") as f:
            json.dump(leaks(repo), f)
    sys.exit(rc)
