"""Run the reference package's own test files against the PyTorch port.

Run as the subprocess that `test_torch_reference_suites.py` starts (the
suite's own process imports it only to test `leaks` and the JAX stub, and
never calls `install`): it installs a `sys.meta_path`
finder that answers `import surrealdb_tpu[.x]` with the already-imported
`surrealdb_tpu_torch[.x]` module, so the reference's tests drive the
port's objects. The port's entry points default to `device="cuda"`; here
`Datastore`, `net.server.serve`, `sdk.local.LocalEngine`,
`IvfState.train`, `_kmeans` and `_full_assign` are wrapped to default to
`"cpu"`, the way the port's own CPU tests pass it. The port
itself gains no knob.

    python tests/torch_reference_hook.py --junitxml=OUT tests/test_kvs.py ...

runs pytest with the repo's `tests/conftest.py` left out (it imports JAX
and primes the reference's tooling) and its `ds` fixture supplied here.
Some reference files `import jax.numpy` at module level and use nothing
of it; the hook answers `jax` and `jax.numpy` with stub modules (marked
by their type, `JaxStub`) whose every other attribute access raises
`StubTouched`, so such a file collects and any real use of JAX fails.
`StubTouched` is not an `AttributeError`, so `hasattr`, a `getattr`
default or `except AttributeError` does not swallow it; only the dunder
names that the import system and pytest probe raise `AttributeError`.
With TORCH_REFERENCE_HOOK_LEAKS=PATH set, it writes to PATH (JSON) any
module of the reference package, real JAX or `scripts/` that the run
loaded; the stubs are not reported.
"""

import functools
import importlib
import importlib.abc
import importlib.util
import inspect
import json
import os
import sys
import types

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


class StubTouched(RuntimeError):
    """A reference test touched the JAX stub: it needs real JAX."""


class JaxStub(types.ModuleType):
    """What `import jax` / `import jax.numpy` gives under the hook. Only the
    import system's own attributes exist (and the submodule the import
    binds); a missing dunder is an AttributeError, anything else raises
    StubTouched."""

    def __getattr__(self, attr):
        if attr.startswith("__") and attr.endswith("__"):
            raise AttributeError(attr)
        raise StubTouched(
            f"{self.__name__}.{attr}: the port's reference run has no JAX "
            "(tests/torch_reference_hook.py stubs it)"
        )


_STUBBED = ("jax", "jax.numpy")


class _StubLoader(importlib.abc.Loader):
    def create_module(self, spec):
        return JaxStub(spec.name)

    def exec_module(self, module):
        pass


class _JaxStubFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname not in _STUBBED:
            return None
        return importlib.util.spec_from_loader(fullname, _StubLoader(), is_package=True)


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
    sys.meta_path.insert(0, _JaxStubFinder())
    from surrealdb_tpu_torch.idx import ivf
    from surrealdb_tpu_torch.kvs.ds import Datastore

    from surrealdb_tpu_torch.net import server
    from surrealdb_tpu_torch.sdk.local import LocalEngine

    Datastore.__init__ = _default_cpu(Datastore.__init__)
    server.serve = _default_cpu(server.serve)
    LocalEngine.__init__ = _default_cpu(LocalEngine.__init__)
    ivf.IvfState.train = staticmethod(_default_cpu(ivf.IvfState.train))
    ivf._kmeans = _default_cpu(ivf._kmeans)
    ivf._full_assign = _default_cpu(ivf._full_assign)


class _Fixtures:
    """The `ds` fixture of tests/conftest.py, whose module is left out."""

    @pytest.fixture()
    def ds(self):
        from surrealdb_tpu.kvs.ds import Datastore

        return Datastore("memory")


def leaks(repo: str, modules=None) -> dict:
    """What a run loaded that it should not have (`modules` defaults to
    sys.modules): a module file of the reference package, or anything of
    real JAX or of the repo's `scripts/`. The hook's JAX stubs are not
    reported."""
    ref_dir = os.path.join(repo, REF) + os.sep
    files, foreign = set(), set()
    for name, mod in list((sys.modules if modules is None else modules).items()):
        if isinstance(mod, JaxStub):
            continue
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
