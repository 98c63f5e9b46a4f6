"""Entry points of the port: a single-device kernel check and the mesh dry
run. The twin of the repository's `__graft_entry__.py`.

`entry(device)` returns the flagship forward step, the fused distance +
top-k (K2) behind the `<|k|>` kNN operator, with its inputs.

`dryrun_multichip(n_devices, device)` runs the "index step" once on tiny
shapes over a mesh of n_devices shards on `device`: vector-mirror ingest (a
scatter into the sharded corpus), exact kNN on a 2-D (rows x features)
mesh (K12: partial distances accumulated over the feature shards, then the
row shards' candidates merged), one CSR frontier hop (K14) and its dedup
(K15); then the 1-D row-sharded query step (K11) and the sharded IVF
search (K13 through IvfState.search_batch_sharded). Both default to CUDA;
the tests pass device="cpu" (the plain versions).
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    from surrealdb_tpu_torch.ops.distances import knn_search

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((1024, 128), dtype=np.float32)).to(dev)
    mask = torch.ones(1024, dtype=torch.bool, device=dev)

    def fn(q, x, mask):
        return knn_search(q, x, mask, "euclidean", 10)

    return fn, (q, x, mask)


def _scatter_rows(st, slots: np.ndarray, rows: np.ndarray) -> None:
    """The ingest step: rows into the sharded corpus (or mask) at `slots`,
    written through the one tensor the shards view (the dry run's shards
    share one device)."""
    idx = torch.from_numpy(slots.astype(np.int64)).to(st.base.device)
    st.base[idx] = torch.from_numpy(rows).to(st.base.device, st.dtype)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The index step over n_devices shards on `device`; returns its
    outputs (host tensors) after checking their shapes and ranges."""
    from surrealdb_tpu_torch.idx.ivf import IvfState, default_nprobe
    from surrealdb_tpu_torch.parallel.mesh import (
        Mesh,
        dedup_frontier,
        make_mesh,
        replicate,
        shard_corpus,
        shard_tensor,
        sharded_frontier_hop,
        sharded_knn,
        sharded_knn_2d,
    )

    dev = torch.device(device)
    devs = [dev] * n_devices
    # 2-D mesh when the shard count splits: rows (data-parallel) x features
    # (tensor-parallel); a 1-D row mesh for odd counts
    if n_devices % 2 == 0:
        d_data, d_model = n_devices // 2, 2
    else:
        d_data, d_model = n_devices, 1
    mesh = Mesh(devs, ("data", "model"), (d_data, d_model))

    rng = np.random.default_rng(0)
    n_rows = 16 * d_data
    dim = 16 * d_model
    k = 4

    corpus_host = rng.standard_normal((n_rows, dim)).astype(np.float32)
    mask_host = np.ones(n_rows, dtype=bool)
    queries_host = rng.standard_normal((4, dim)).astype(np.float32)
    new_rows_host = rng.standard_normal((d_data, dim)).astype(np.float32)
    slot_host = np.arange(d_data, dtype=np.int32) * (n_rows // d_data)

    corpus = shard_tensor(mesh, corpus_host, ("data", "model"))
    mask = shard_tensor(mesh, mask_host, ("data",))
    queries = shard_tensor(mesh, queries_host, (None, "model"))

    # tiny CSR: a ring graph, replicated (edge tables are small vs vectors)
    n_nodes = 8 * d_data
    indptr = replicate(mesh, np.arange(n_nodes + 1, dtype=np.int32))
    indices = replicate(mesh, ((np.arange(n_nodes) + 1) % n_nodes).astype(np.int32))
    frontier = shard_tensor(mesh, np.arange(d_data * 2, dtype=np.int32), ("data",))
    fmask = shard_tensor(mesh, np.ones(d_data * 2, dtype=bool), ("data",))

    # 1) ingest: scatter freshly-indexed vectors into the sharded mirror
    _scatter_rows(corpus, slot_host, new_rows_host)
    _scatter_rows(mask, slot_host, np.ones(d_data, dtype=bool))
    # 2) sharded exact kNN (feature-shard accumulation + row-shard merge)
    dists, idxs = sharded_knn_2d(mesh, corpus, mask, queries, k)
    # 3) one graph frontier hop + dedup
    nbrs, nmask = sharded_frontier_hop(mesh, indptr, indices, frontier, fmask, 1)
    uniq, umask = dedup_frontier(nbrs, nmask, n_nodes)

    # sanity: k results per query, all indices in range
    assert tuple(dists.shape) == (4, k) and tuple(idxs.shape) == (4, k)
    assert int(idxs.max()) < n_rows and bool(torch.isfinite(dists).all())
    assert int(umask.sum()) == d_data * 2

    # also exercise the 1-D row-sharded path (the production default)
    mesh1 = make_mesh(n_devices, devices=devs)
    c1 = shard_corpus(mesh1, rng.standard_normal((8 * n_devices, 16)).astype(np.float32))
    m1 = shard_tensor(mesh1, np.ones(8 * n_devices, dtype=bool), ("data",))
    q1 = torch.from_numpy(np.ascontiguousarray(queries_host[:, :16]))
    d1, i1 = sharded_knn(mesh1, c1, m1, q1, k)
    assert tuple(d1.shape) == (4, k)

    # sharded IVF (ANN composed with the mesh): replicated centroids,
    # per-shard inverted lists, all-gather of per-shard top-k
    n1 = 8 * n_devices
    x1 = rng.standard_normal((n1, 16)).astype(np.float32)
    ivf = IvfState.train(x1, np.ones(n1, dtype=bool), nlists=8, device=dev)
    c1b = shard_corpus(mesh1, x1)
    dd, ss = ivf.search_batch_sharded(
        queries_host[:, :16], mesh1, c1b, "euclidean", k, default_nprobe(ivf.nlists, 80),
    )
    assert dd.shape == (4, k) and ss.shape == (4, k)
    return {
        "dists": dists.cpu(), "idxs": idxs.cpu(), "nbrs": nbrs.cpu(), "nmask": nmask.cpu(),
        "uniq": uniq.cpu(), "umask": umask.cpu(), "d1": d1.cpu(), "i1": i1.cpu(),
        "ivf_dists": dd, "ivf_slots": ss, "ivf_lists": ivf.lists,
    }


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
    print("dryrun_multichip OK")
