"""vector:: functions (reference: core/src/fnc/vector.rs).

Element-wise ops and distances over numeric arrays. Single-pair calls run on
host (tiny inputs); the batched query path (kNN operator, brute-force plans)
uses the MXU kernels in ops/distances.py.
"""

from __future__ import annotations

import math

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.ops.distances import distance_single

from . import register


def _vec(v, name):
    if not isinstance(v, (list, tuple)):
        raise InvalidArgumentsError(name, "Argument was the wrong type. Expected a vector.")
    try:
        return [float(x) for x in v]
    except (TypeError, ValueError):
        raise InvalidArgumentsError(name, "Vectors must contain only numbers.")


def _pair(a, b, name):
    va, vb = _vec(a, name), _vec(b, name)
    if len(va) != len(vb):
        raise InvalidArgumentsError(name, "The two vectors must be of the same dimension.")
    return va, vb


@register("vector::add")
def add(ctx, a, b):
    va, vb = _pair(a, b, "vector::add")
    return [x + y for x, y in zip(va, vb)]


@register("vector::subtract")
def subtract(ctx, a, b):
    va, vb = _pair(a, b, "vector::subtract")
    return [x - y for x, y in zip(va, vb)]


@register("vector::multiply")
def multiply(ctx, a, b):
    va, vb = _pair(a, b, "vector::multiply")
    return [x * y for x, y in zip(va, vb)]


@register("vector::divide")
def divide(ctx, a, b):
    va, vb = _pair(a, b, "vector::divide")
    return [x / y if y != 0 else math.nan for x, y in zip(va, vb)]


@register("vector::scale")
def scale(ctx, a, s):
    return [x * float(s) for x in _vec(a, "vector::scale")]


@register("vector::dot")
def dot(ctx, a, b):
    va, vb = _pair(a, b, "vector::dot")
    return sum(x * y for x, y in zip(va, vb))


@register("vector::cross")
def cross(ctx, a, b):
    va, vb = _pair(a, b, "vector::cross")
    if len(va) != 3:
        raise InvalidArgumentsError("vector::cross", "Both vectors must have a dimension of 3.")
    return [
        va[1] * vb[2] - va[2] * vb[1],
        va[2] * vb[0] - va[0] * vb[2],
        va[0] * vb[1] - va[1] * vb[0],
    ]


@register("vector::magnitude")
def magnitude(ctx, a):
    return math.sqrt(sum(x * x for x in _vec(a, "vector::magnitude")))


@register("vector::normalize")
def normalize(ctx, a):
    va = _vec(a, "vector::normalize")
    m = math.sqrt(sum(x * x for x in va))
    if m == 0:
        return va
    return [x / m for x in va]


@register("vector::angle")
def angle(ctx, a, b):
    va, vb = _pair(a, b, "vector::angle")
    ma = math.sqrt(sum(x * x for x in va))
    mb = math.sqrt(sum(x * x for x in vb))
    if ma == 0 or mb == 0:
        raise InvalidArgumentsError("vector::angle", "Cannot compute the angle with a zero vector.")
    c = sum(x * y for x, y in zip(va, vb)) / (ma * mb)
    return math.acos(max(-1.0, min(1.0, c)))


@register("vector::project")
def project(ctx, a, b):
    va, vb = _pair(a, b, "vector::project")
    mb2 = sum(x * x for x in vb)
    if mb2 == 0:
        raise InvalidArgumentsError("vector::project", "Cannot project onto a zero vector.")
    s = sum(x * y for x, y in zip(va, vb)) / mb2
    return [s * x for x in vb]


# -------------------------------------------------------------- distances
def _distance(metric, alias=None):
    name = alias or f"vector::distance::{metric}"

    @register(name)
    def f(ctx, a, b, _m=metric, _n=name):
        va, vb = _pair(a, b, _n)
        return distance_single(va, vb, _m)

    return f


_distance("chebyshev")
_distance("euclidean")
_distance("hamming")
_distance("manhattan")


@register("vector::distance::minkowski")
def minkowski(ctx, a, b, p):
    va, vb = _pair(a, b, "vector::distance::minkowski")
    return distance_single(va, vb, f"minkowski:{float(p)}")


@register("vector::distance::knn")
def knn_distance(ctx, *args):
    """The distance computed by the `<|k|>` operator for the current record
    (reference: fnc/vector.rs:75 vector::distance::knn)."""
    from surrealdb_tpu_torch.sql.value import NONE

    qe = ctx.query_executor()
    if qe is None or ctx.doc is None or ctx.doc.rid is None:
        return NONE
    # prefer the per-record index-result metadata
    ir = getattr(ctx.doc, "ir", None)
    if ir and "dist" in ir:
        return ir["dist"]
    d = qe.knn_distance(ctx.doc.rid)
    return d if d is not None else NONE


@register("vector::similarity::cosine")
def similarity_cosine(ctx, a, b):
    va, vb = _pair(a, b, "vector::similarity::cosine")
    return 1.0 - distance_single(va, vb, "cosine")


@register("vector::similarity::jaccard")
def similarity_jaccard(ctx, a, b):
    va, vb = _pair(a, b, "vector::similarity::jaccard")
    return 1.0 - distance_single(va, vb, "jaccard")


@register("vector::similarity::pearson")
def similarity_pearson(ctx, a, b):
    va, vb = _pair(a, b, "vector::similarity::pearson")
    return 1.0 - distance_single(va, vb, "pearson")


@register("vector::similarity::spearman")
def spearman(ctx, a, b):
    """Spearman rank correlation — implemented for real where the reference
    returns FeatureNotYetImplemented (fnc/vector.rs:132)."""
    import numpy as _np

    va = _np.asarray(_vec(a, "vector::similarity::spearman"), dtype=float)
    vb = _np.asarray(_vec(b, "vector::similarity::spearman"), dtype=float)
    if va.shape != vb.shape:
        from surrealdb_tpu_torch.err import InvalidArgumentsError

        raise InvalidArgumentsError(
            "vector::similarity::spearman",
            "The two vectors must be of the same dimension.",
        )

    def rank(x):
        order = _np.argsort(x, kind="stable")
        r = _np.empty_like(order, dtype=float)
        r[order] = _np.arange(len(x), dtype=float)
        # average ties
        for v in _np.unique(x):
            m = x == v
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    ra, rb = rank(va), rank(vb)
    da, db_ = ra - ra.mean(), rb - rb.mean()
    denom = float(_np.sqrt((da**2).sum() * (db_**2).sum()))
    return float((da * db_).sum() / denom) if denom else 0.0


@register("vector::distance::mahalanobis")
def mahalanobis(ctx, a, b):
    from surrealdb_tpu_torch.err import SurrealError

    raise SurrealError(
        "vector::distance::mahalanobis() is not implemented (it requires a "
        "covariance matrix; the reference leaves it unimplemented too)"
    )
