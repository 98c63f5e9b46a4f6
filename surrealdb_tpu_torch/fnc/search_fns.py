"""search:: functions — full-text scoring hooks
(reference: core/src/fnc/search.rs:11-45)."""

from __future__ import annotations

from surrealdb_tpu_torch.sql.value import NONE

from . import register


@register("search::score")
def score(ctx, ref=None):
    doc = ctx.doc
    if doc is not None and doc.ir and "score" in doc.ir:
        return doc.ir["score"]
    qe = ctx.query_executor()
    if qe is not None and doc is not None:
        s = qe.score(ctx, doc, ref)
        if s is not None:
            return s
    return NONE


@register("search::highlight")
def highlight(ctx, prefix, suffix, ref=None, whole_term=None):
    qe = ctx.query_executor()
    doc = ctx.doc
    if qe is not None and doc is not None and hasattr(qe, "highlight"):
        return qe.highlight(ctx, doc, str(prefix), str(suffix), ref)
    return NONE


@register("search::offsets")
def offsets(ctx, ref=None, partial=None):
    qe = ctx.query_executor()
    doc = ctx.doc
    if qe is not None and doc is not None and hasattr(qe, "offsets"):
        return qe.offsets(ctx, doc, ref)
    return NONE


@register("search::analyze")
def analyze(ctx, analyzer, text):
    """Run a DEFINEd analyzer over a string and return its terms
    (reference: fnc/search.rs analyze)."""
    from surrealdb_tpu_torch.idx.ft_analyzer import analyzer_for

    az = analyzer_for(ctx, str(analyzer))
    return az.terms(str(text))
