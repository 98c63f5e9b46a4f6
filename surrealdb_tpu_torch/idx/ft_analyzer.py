"""Full-text analyzers: tokenizers + filters.

Role of the reference's analyzer machinery (reference:
core/src/idx/ft/analyzer/ — tokenizers blank/camel/class/punct in
tokenizer.rs, filters lowercase/uppercase/ascii/edgengram/ngram/snowball/
mapper in filter.rs:99-140). DEFINE ANALYZER definitions are stored by the
catalog; this module compiles one into a callable pipeline.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Iterable, List, Optional, Tuple

Token = Tuple[str, int, int]  # (text, start, end) byte offsets in chars


# ------------------------------------------------------------------ tokenizers
def _tok_blank(text: str) -> List[Token]:
    out = []
    for m in re.finditer(r"\S+", text):
        out.append((m.group(), m.start(), m.end()))
    return out


def _tok_punct(text: str) -> List[Token]:
    out = []
    for m in re.finditer(r"[^\s\W]+|\w+", text, re.UNICODE):
        out.append((m.group(), m.start(), m.end()))
    return out


def _split_further(tokens: List[Token], pattern: str) -> List[Token]:
    out: List[Token] = []
    rx = re.compile(pattern)
    for text, start, _ in tokens:
        pos = 0
        for m in rx.finditer(text):
            seg = m.group()
            out.append((seg, start + m.start(), start + m.end()))
    return out


def _tok_camel(tokens: List[Token]) -> List[Token]:
    """Split camelCase boundaries within existing tokens."""
    out: List[Token] = []
    for text, start, end in tokens:
        parts = re.finditer(r"[A-Z]+(?![a-z])|[A-Z][a-z]*|[a-z]+|\d+", text)
        found = False
        for m in parts:
            found = True
            out.append((m.group(), start + m.start(), start + m.end()))
        if not found:
            out.append((text, start, end))
    return out


def _tok_class(tokens: List[Token]) -> List[Token]:
    """Split on character-class changes (letter/digit/punct)."""
    out: List[Token] = []
    for text, start, end in tokens:
        for m in re.finditer(r"[^\W\d_]+|\d+|[^\w\s]+", text, re.UNICODE):
            out.append((m.group(), start + m.start(), start + m.end()))
    return out


# ------------------------------------------------------------------ filters
def _f_lowercase(toks: List[Token]) -> List[Token]:
    return [(t.lower(), s, e) for t, s, e in toks]


def _f_uppercase(toks: List[Token]) -> List[Token]:
    return [(t.upper(), s, e) for t, s, e in toks]


def _f_ascii(toks: List[Token]) -> List[Token]:
    out = []
    for t, s, e in toks:
        nk = unicodedata.normalize("NFKD", t)
        out.append(("".join(c for c in nk if not unicodedata.combining(c)), s, e))
    return out


def _f_ngram(min_n: int, max_n: int):
    def f(toks: List[Token]) -> List[Token]:
        out = []
        for t, s, e in toks:
            for n in range(min_n, max_n + 1):
                for i in range(0, max(len(t) - n + 1, 0)):
                    out.append((t[i : i + n], s, e))
        return out

    return f


def _f_edgengram(min_n: int, max_n: int):
    def f(toks: List[Token]) -> List[Token]:
        out = []
        for t, s, e in toks:
            for n in range(min_n, min(max_n, len(t)) + 1):
                out.append((t[:n], s, e))
        return out

    return f


# A compact Porter-style English stemmer fills the reference's snowball role
# for `snowball(english)`; other languages pass through unstemmed.
_VOWELS = "aeiou"


def _porter_stem(w: str) -> str:
    if len(w) <= 2:
        return w
    for suf, rep in (
        ("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", ""),
    ):
        if w.endswith(suf):
            if suf == "s" and w.endswith(("us", "ss")):
                break
            w = w[: len(w) - len(suf)] + rep
            break
    for suf in ("eed", "ed", "ing"):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if suf == "eed":
                if _measure(stem) > 0:
                    w = stem + "ee"
            elif any(c in _VOWELS for c in stem):
                w = stem
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif len(w) > 1 and w[-1] == w[-2] and w[-1] not in "lsz":
                    w = w[:-1]
                elif _measure(w) == 1 and _cvc(w):
                    w += "e"
            break
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("izer", "ize"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"), ("biliti", "ble"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iviti", "ive"),
        ("ement", ""), ("ment", ""), ("ent", ""), ("tion", "t"), ("ence", ""),
        ("ance", ""), ("able", ""), ("ible", ""), ("ize", ""), ("ive", ""),
        ("ous", ""), ("iti", ""), ("al", ""), ("er", ""), ("ic", ""),
    ):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 1:
                w = stem + rep
            break
    if w.endswith("e") and _measure(w[:-1]) > 1:
        w = w[:-1]
    return w


def _measure(w: str) -> int:
    m = 0
    prev_v = False
    for c in w:
        v = c in _VOWELS
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    c1, v, c2 = w[-3] not in _VOWELS, w[-2] in _VOWELS, w[-1] not in _VOWELS
    return c1 and v and c2 and w[-1] not in "wxy"


def _f_snowball(lang: str):
    if str(lang).lower() in ("english", "en"):
        return lambda toks: [(_porter_stem(t), s, e) for t, s, e in toks]
    return lambda toks: toks


# ------------------------------------------------------------------ compiler
class Analyzer:
    """Compiled DEFINE ANALYZER pipeline."""

    def __init__(self, definition: Optional[dict]):
        d = definition or {}
        self.tokenizers = [t.lower() for t in d.get("tokenizers", ["blank"])] or ["blank"]
        self.filters = []
        for f in d.get("filters", []):
            name = f["name"].lower()
            args = f.get("args", [])
            if name == "lowercase":
                self.filters.append(_f_lowercase)
            elif name == "uppercase":
                self.filters.append(_f_uppercase)
            elif name == "ascii":
                self.filters.append(_f_ascii)
            elif name == "ngram":
                self.filters.append(_f_ngram(int(args[0]), int(args[1])))
            elif name == "edgengram":
                self.filters.append(_f_edgengram(int(args[0]), int(args[1])))
            elif name == "snowball":
                self.filters.append(_f_snowball(args[0] if args else "english"))
            # mapper (lemma files) accepted but inert until file loading lands

        # Offset-free fast mode: a blank tokenizer with only case filters is
        # exactly str.split() over the case-folded text. Bulk ingest (which
        # never needs highlight offsets) rides this; any other pipeline
        # falls back to the full analyzer.
        names = [f["name"].lower() for f in (d.get("filters") or [])]
        if self.tokenizers == ["blank"] and all(
            n in ("lowercase", "uppercase") for n in names
        ):
            if "lowercase" in names:
                self._fast = "lower"
            elif "uppercase" in names:
                self._fast = "upper"
            else:
                self._fast = "plain"
        else:
            self._fast = None

    def terms_fast(self, text: str) -> List[str]:
        """Term list without offsets — cheap path for bulk indexing."""
        if self._fast == "lower":
            return text.lower().split()
        if self._fast == "upper":
            return text.upper().split()
        if self._fast == "plain":
            return text.split()
        return self.terms(text)

    def analyze(self, text: str) -> List[Token]:
        toks = _tok_blank(text)
        if "punct" in self.tokenizers:
            toks = _split_further(toks, r"\w+|[^\w\s]+")
        if "class" in self.tokenizers:
            toks = _tok_class(toks)
        if "camel" in self.tokenizers:
            toks = _tok_camel(toks)
        for f in self.filters:
            toks = f(toks)
        return [t for t in toks if t[0]]

    def terms(self, text: str) -> List[str]:
        return [t for t, _, _ in self.analyze(text)]


DEFAULT_LIKE = Analyzer(
    {"tokenizers": ["blank", "class"], "filters": [{"name": "lowercase", "args": []}]}
)


def analyzer_for(ctx, name: Optional[str]) -> Analyzer:
    """Resolve an analyzer by catalog name; the built-in fallback mirrors the
    reference's default `like` behavior."""
    if not name or name == "like":
        return DEFAULT_LIKE
    ns, db = ctx.ns_db()
    d = ctx.txn().get_az(ns, db, name)
    if d is None:
        from surrealdb_tpu_torch.err import AzNotFoundError

        raise AzNotFoundError(name)
    return Analyzer(d)
