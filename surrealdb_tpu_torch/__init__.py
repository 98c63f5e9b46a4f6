"""surrealdb_tpu_torch — the PyTorch/CUDA port of the JAX package surrealdb_tpu/.

The same SurrealQL engine, with its device-resident index mirrors held as
torch tensors and its data-parallel search kernels written by hand in CUDA
C++ for Hopper (csrc/). This package imports neither JAX nor anything of
surrealdb_tpu/, which stays beside it, unchanged, as the reference.

Entry point: `surrealdb_tpu_torch.kvs.ds.Datastore("memory")`, which runs on
the CUDA device unless it is given `device="cpu"`. See ROADMAP.md for what is
ported and what still raises NotImplementedError.
"""

__version__ = "0.1.0"
