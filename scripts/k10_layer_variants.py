#!/usr/bin/env python3
"""K10's model layers (csrc/ml.cu `ml_linear` with a layer's epilogue,
act(h @ W + b)) against variants of the wide path's layer instance, on one
CUDA card. Each variant is a copy of the tree's ml.cu with lines replaced,
built alone by nvcc, all side by side; with --old-tree, that checkout's
ml.cu too (a tree from before the epilogue program, whose ml_linear takes
the bias and an activation code), as variant "old". Each is held against
the plain layer (`linear_act_plain`, TOL) and timed queued (and by events)
at chip_smoke.py's K10 shapes over 2^20 rows: the MLP's 768 -> 128 relu on
the bf16 mirror, 128 -> 64 tanh, 768 -> 64 (wide f32), 768 -> 16 bf16 and
128 -> 10 (narrow), 768 -> 1 bf16 (skinny). Four rounds, every other one
in reverse variant order, so each pair compares within one call.

    python3 scripts/k10_layer_variants.py                       # every variant
    python3 scripts/k10_layer_variants.py base bias_test
    python3 scripts/k10_layer_variants.py --old-tree DIR --out k10.json

Builds go under surrealdb_tpu_torch/_build/k10_variants/. One JSON line a
measurement on stdout (the ptxas lines of each build's wide_kernel
instances first); exits 1 if a variant disagrees with the plain layer.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STORE = "v[u] = __fadd_rn(v[u], lb[col + u]);"

# name: (what it changes, [(text in ml.cu, its replacement)])
VARIANTS = {
    "base": ("the tree's ml.cu", []),
    "bias_test": ("the layer instance tests for a missing bias at each store",
                  [(_STORE, "if (lb != nullptr) " + _STORE)]),
    "generic": ("a layer's program through epi_tile over a copy of the tile, as any other",
                [("  if (epi_layer(epi, layer))\n", "  if (false && epi_layer(epi, layer))\n")]),
}

CASES = [  # label, K, N, x dtype, activation
    ("wide_768x128_relu_bf16", 768, 128, "bfloat16", "relu"),
    ("wide_128x64_tanh_f32", 128, 64, "float32", "tanh"),
    ("wide_768x64_f32", 768, 64, "float32", None),
    ("narrow_768x16_bf16", 768, 16, "bfloat16", None),
    ("narrow_128x10_f32", 128, 10, "float32", None),
    ("skinny_768x1_bf16", 768, 1, "bfloat16", None),
]
OLD_ACT = {None: 0, "relu": 1, "tanh": 2, "sigmoid": 3}  # the old ml_linear's codes


def build(jobs, cuda):
    """{name: loaded library} of each (name, csrc dir, ml.cu text), built
    side by side."""
    from scripts.k3_k7_timing import ptxas_report

    out = os.path.join(ROOT, "surrealdb_tpu_torch", "_build", "k10_variants")
    cmds, sos = [], {}
    for name, csrc, text in jobs:
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        with open(os.path.join(d, "ml.cu"), "w") as f:
            f.write(text)
        obj, so = os.path.join(d, "ml.o"), os.path.join(d, "libml.so")
        cmds.append(["bash", "-c", " ".join(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-c", "-o", obj, os.path.join(d, "ml.cu"), "&&",
             cuda._nvcc(), *cuda.ARCH_FLAGS, "-shared", "-o", so, obj])])
        sos[name] = so
    secs = []
    results = cuda._run_all(cmds, out, secs)
    libs = {}
    for (name, _, _), (rc, log), t in zip(jobs, results, secs):
        if rc != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(sos[name])
        print(json.dumps({"what": "build", "variant": name, "seconds": t,
                          "ptxas": ptxas_report(log, names=("wide_kernel",))}), flush=True)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"default: all of {', '.join(VARIANTS)}")
    ap.add_argument("--old-tree", help="a checkout whose ml.cu takes (b, act): variant 'old'")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k10_layer_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from surrealdb_tpu_torch.ml import model as ML
    from surrealdb_tpu_torch.ops import _cuda

    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"what": "environment", "nvidia_smi": C.phase_environment(torch)})
    with open(os.path.join(_cuda.CSRC, "ml.cu")) as f:
        src = f.read()
    jobs = []
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in ml.cu once")
            text = text.replace(old, new)
        jobs.append((name, _cuda.CSRC, text))
    if args.old_tree:
        old_csrc = os.path.join(os.path.abspath(args.old_tree), "surrealdb_tpu_torch", "csrc")
        with open(os.path.join(old_csrc, "ml.cu")) as f:
            jobs.append(("old", old_csrc, f.read()))
    libs = build(jobs, _cuda)
    restype, argtypes = _cuda._SIGNATURES["ml_linear"]
    for name, lib in libs.items():
        if name == "old":  # x, x_bf16, w, b, M, K, N, act, out, stream
            P = ctypes.c_void_p
            lib.ml_linear.restype = ctypes.c_int
            lib.ml_linear.argtypes = [P, ctypes.c_int, P, P, ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, P, P]
        else:
            lib.ml_linear.restype, lib.ml_linear.argtypes = restype, argtypes
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    m = 1 << 20
    failed = []
    for label, k, n, dtype, act in CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        w = torch.randn(k, n, device=dev, generator=g) / k ** 0.5
        b = torch.randn(n, device=dev, generator=g)
        ep = ML.Epilogue.layer(b, act)
        want = ML.linear_act_plain(x, w, ep)
        y = torch.empty(m, n, device=dev)

        def runner(name):
            lib = libs[name]
            if name == "old":
                return lambda: lib.ml_linear(x.data_ptr(), int(dt == torch.bfloat16), w.data_ptr(),
                                             b.data_ptr(), m, k, n, OLD_ACT[act], y.data_ptr(),
                                             stream)
            return lambda: ML._launch_linear(lib, x, w, ep, y, stream)

        runs = {name: runner(name) for name in libs}
        for name, run in runs.items():
            y.zero_()
            rc = run()
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            if rc != 0 or not torch.allclose(y, want, **C.TOL):
                failed.append(f"{name} {label} (rc {rc}, max abs error {err})")
        queued = {name: [] for name in runs}
        for rnd in range(4):
            for name in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
                queued[name].append(C.queued_device_ms(torch, runs[name]))
        emit({"what": "k10_layer", "case": label, "m": m, "k": k, "n": n, "x": dtype, "act": act,
              "queued_ms_median": {nm: statistics.median(t) for nm, t in queued.items()},
              "queued_ms": queued, "ms": {nm: C.median_ms(r) for nm, r in runs.items()}})
        del x, y, want
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if failed:
        print(f"k10_layer_variants: disagree with the plain layer: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
