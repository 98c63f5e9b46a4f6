"""MATCHES (@@) query plan over the inverted index.

Role of the reference's MatchesThingIterator + per-doc matches()/score()/
highlight() hooks (reference: core/src/idx/planner/iterators.rs:849-904,
executor.rs:878-1102, fnc/search.rs). The plan object implements the
QueryExecutor protocol consulted by the MATCHES operator and the search::
functions during document processing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from surrealdb_tpu_torch.sql.value import NONE, Thing

from .ft_index import FtIndex


class MatchesPlan:
    def __init__(self, tb: str, ix: dict, op, query):
        self.tb = tb
        self.ix = ix
        self.op = op
        self.query = query if isinstance(query, str) else str(query)
        self.ft = FtIndex.for_index(None, ix)
        self.results = None  # FtResults after iterate()
        self.provides_order = False  # set by the planner (score-order pushdown)
        self.order_pushed = False  # set by stmt_exec when it's the only source

    def explain(self) -> dict:
        return {
            "index": self.ix["name"],
            "operator": f"@{self.op.ref if self.op.ref is not None else ''}@",
            "query": self.query,
        }

    # ------------------------------------------------------------ iteration
    def iterate(self, ctx):
        ctx.qe = self
        ns, db = ctx.ns_db()
        want = (ns, db, self.tb, self.ix["name"])
        pending = getattr(ctx.txn(), "ft_deltas", None)
        if pending and any(d[1:5] == want for d in pending):
            # this txn has uncommitted writes to the index: exact KV search
            # (sees the txn's own writes; the shared mirror must not)
            self.results = self.ft.search(ctx, self.query)
        else:
            from .ft_index import FtResults
            from .ft_mirror import FtMirror

            mirror = ctx.ds().index_stores.get_or_create(
                ns, db, self.tb, self.ix["name"], FtMirror
            )
            mirror.ensure_built(ctx, self.ix)
            terms = self.ft.analyzer(ctx).terms(self.query)
            k1 = float(self.ix["index"].get("k1", 1.2))
            b = float(self.ix["index"].get("b", 0.75))
            # cluster mode: the coordinator injects merged GLOBAL corpus
            # stats so per-shard scoring matches one single-node corpus
            # (cluster/executor.py two-phase BM25)
            stats = ctx.get_param("__cluster_ft_stats")
            dids, scores = mirror.search(
                terms, k1, b,
                stats_override=stats if isinstance(stats, dict) else None,
            )
            import numpy as np

            order = np.argsort(-scores, kind="stable")
            if self.order_pushed:
                # single-source score-ordered scan: LIMIT stops iteration
                # after a handful of rows, so materialize rids lazily and
                # fill the score lookup as docs are yielded (only yielded
                # docs are ever probed by matches()/score())
                self.results = FtResults(self.ft, {}, terms)
                by_rid = self.results.by_rid
                for i in order:
                    rid = mirror.rid_for(int(dids[i]))
                    if rid is None:
                        continue
                    s = float(scores[i])
                    by_rid[(rid.tb, repr(rid.id))] = (rid, s)
                    yield rid, None, {"score": s}
                return
            by_rid = {}
            for i in order:
                rid = mirror.rid_for(int(dids[i]))
                if rid is not None:
                    by_rid[(rid.tb, repr(rid.id))] = (rid, float(scores[i]))
            self.results = FtResults(self.ft, by_rid, terms)
            for rid, score in by_rid.values():
                yield rid, None, {"score": score}
            return
        ranked = sorted(self.results, key=lambda rs: -rs[1])
        for rid, score in ranked:
            yield rid, None, {"score": score}

    # ------------------------------------------------------------ executor protocol
    def matches(self, ctx, doc, op) -> bool:
        if self.results is None or doc.rid is None:
            return False
        return self.results.contains(doc.rid)

    def knn(self, ctx, doc, op) -> bool:
        return False

    def knn_distance(self, rid) -> Optional[float]:
        return None

    def score(self, ctx, doc, ref=None) -> Optional[float]:
        if self.results is None or doc.rid is None:
            return None
        return self.results.score(doc.rid)

    def highlight(self, ctx, doc, prefix: str, suffix: str, ref=None):
        if self.results is None or doc.rid is None:
            return NONE
        offs = self.ft.offsets_for(ctx, doc.rid, self.results.terms)
        if not offs:
            return NONE
        # apply to the indexed field's current value
        field = self.op.l
        with ctx.with_doc_value(doc.current, rid=doc.rid) as c:
            text = field.compute(c)
        if not isinstance(text, str):
            return NONE
        out = []
        last = 0
        for s, e in offs:
            if s < last or e > len(text):
                continue
            out.append(text[last:s])
            out.append(prefix + text[s:e] + suffix)
            last = e
        out.append(text[last:])
        return "".join(out)

    def offsets(self, ctx, doc, ref=None):
        if self.results is None or doc.rid is None:
            return NONE
        offs = self.ft.offsets_for(ctx, doc.rid, self.results.terms)
        return {"0": [{"s": s, "e": e} for s, e in offs]} if offs else NONE
