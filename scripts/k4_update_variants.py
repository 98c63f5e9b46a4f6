#!/usr/bin/env python3
"""K4's update (csrc/ivf.cu `ivf_kmeans_update`) against variants of its
constants, on one CUDA card. Each variant is a copy of the tree's ivf.cu
with constants replaced, built alone by nvcc, all side by side; each is
held against the plain update (counts equal, TOL) and timed by events and
queued, with torch.profiler's device time of each of its launches, on
65,536 x 768 bf16 rows and 1,024 centroids at chip_smoke.py's two
assignments (k4_assignments: the training's first step, "first_step", and
its second, "means"), at the first step with 90% of the rows moved to one
centroid ("skewed") and at the first step sorted, so each cluster's rows
are contiguous ("sorted"). Beside them, `x.sum(0)` over the same rows: the
rate one PyTorch pass reads them at. Two rounds, the second in reverse
variant order, so each pair compares within one call.

    python3 scripts/k4_update_variants.py                 # every variant
    python3 scripts/k4_update_variants.py base loads16    # some of them
    python3 scripts/k4_update_variants.py --out chiprun_out/k4_variants.json

Builds go under surrealdb_tpu_torch/_build/k4_variants/. One JSON line a
measurement on stdout; exits 1 if a variant disagrees with the plain update.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _set(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# name: (what it changes, [(text in ivf.cu, its replacement)])
VARIANTS = {
    "base": ("the tree's ivf.cu", []),
    "hist8": ("launch 2 reads a thread's tile counts 8 at a time, not 32",
              [("#pragma unroll 32\n    for (int u = 0; u < NT; ++u) {",
                "#pragma unroll 8\n    for (int u = 0; u < NT; ++u) {")]),
    "loads4": ("4 rows in flight a sum thread", [_set("UP_LOADS", 8, 4)]),
    "loads16": ("16 rows in flight a sum thread", [_set("UP_LOADS", 8, 16)]),
    "item64": ("work items of 64 members", [_set("UP_ITEM", 128, 64)]),
    "item96": ("work items of 96 members", [_set("UP_ITEM", 128, 96)]),
    "item256_loads16": ("work items of 256 members, 16 rows in flight",
                        [_set("UP_ITEM", 128, 256), _set("UP_LOADS", 8, 16)]),
    "tile1024": ("1,024-entry tiles, at most 64", [_set("UP_UNROLL", 8, 4),
                                                   _set("UP_MAX_TILES", 32, 64)]),
}


def build(names, src, cuda):
    """{name: loaded library} of each variant, built side by side."""
    from scripts.k3_k7_timing import ptxas_report

    out = os.path.join(ROOT, "surrealdb_tpu_torch", "_build", "k4_variants")
    cmds, sos = [], {}
    for name in names:
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda.CSRC, d)
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in ivf.cu once")
            text = text.replace(old, new)
        with open(os.path.join(d, "ivf.cu"), "w") as f:
            f.write(text)
        obj, so = os.path.join(d, "ivf.o"), os.path.join(d, "libivf.so")
        cmds.append(["bash", "-c", " ".join(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-c", "-o", obj, os.path.join(d, "ivf.cu"), "&&",
             cuda._nvcc(), *cuda.ARCH_FLAGS, "-shared", "-o", so, obj])])
        sos[name] = so
    secs = []
    results = cuda._run_all(cmds, out, secs)
    libs = {}
    for name, (rc, log), t in zip(names, results, secs):
        if rc != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log[-3000:]}")
        handle = ctypes.CDLL(sos[name])
        for fn, (restype, argtypes) in cuda._SIGNATURES.items():
            f = getattr(handle, fn, None)
            if f is not None:
                f.restype, f.argtypes = restype, argtypes
        libs[name] = handle
        print(json.dumps({"what": "build", "variant": name, "seconds": t,
                          "ptxas": ptxas_report(log, names=("up_",))}), flush=True)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"default: all of {', '.join(VARIANTS)}")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k4_update_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import _cuda

    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"what": "environment", "nvidia_smi": C.phase_environment(torch)})
    with open(os.path.join(_cuda.CSRC, "ivf.cu")) as f:
        libs = build(names, f.read(), _cuda)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(C.gen_corpus(65_536, C.DIM, seed=3)).to(dev).to(torch.bfloat16)
    cases = C.k4_assignments(torch, x, 1024)
    first, seeds = cases["first_step"]
    skewed = first.clone()
    skewed[torch.rand(x.shape[0], generator=torch.Generator().manual_seed(4)).to(dev) < 0.9] = 3
    cases["skewed"] = (skewed, seeds)
    cases["sorted"] = (torch.sort(first)[0].contiguous(), seeds)
    rows_sum = lambda: x.sum(0, dtype=torch.float32)  # noqa: E731
    emit({"what": "x_sum_dim0", "ms": C.median_ms(rows_sum),
          "queued_ms": C.queued_device_ms(torch, rows_sum)})
    failed = []
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            for case, (a, c) in cases.items():
                run = lambda: IVF._launch_kmeans_update(libs[name], x, a, c)  # noqa: E731
                got, got_n = run()
                torch.cuda.synchronize()
                want, want_n = IVF.kmeans_update_plain(x, a, c)
                ok = bool(torch.allclose(got, want, **C.TOL)) and bool(torch.equal(got_n, want_n))
                if not ok:
                    failed.append(f"{name} {case}")
                rec = {"what": "k4_update", "variant": name, "round": rnd, "assignment": case,
                       "ok": ok, "largest_count": int(want_n.max()), "ms": C.median_ms(run),
                       "queued_ms": C.queued_device_ms(torch, run)}
                if rnd == 0:
                    rec["kernels_a_call"] = C.kernels_per_call(torch, run)
                emit(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if failed:
        print(f"k4_update_variants: disagree with the plain update: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
