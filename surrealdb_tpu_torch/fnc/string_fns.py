"""string:: functions (reference: core/src/fnc/string.rs)."""

from __future__ import annotations

import re
import unicodedata
from typing import Any

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import NONE, format_value

from . import register


def _s(v, name="string") -> str:
    if not isinstance(v, str):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected a string.")
    return v


@register("string::concat")
def concat(ctx, *parts):
    return "".join(p if isinstance(p, str) else format_value(p) for p in parts)


@register("string::contains")
def contains(ctx, s, sub):
    return _s(sub) in _s(s)


@register("string::ends_with")
def ends_with(ctx, s, suffix):
    return _s(s).endswith(_s(suffix))


@register("string::starts_with")
def starts_with(ctx, s, prefix):
    return _s(s).startswith(_s(prefix))


@register("string::join")
def join(ctx, sep, *parts):
    return _s(sep).join(p if isinstance(p, str) else format_value(p) for p in parts)


@register("string::len")
def len_(ctx, s):
    return len(_s(s))


@register("string::lowercase")
def lowercase(ctx, s):
    return _s(s).lower()


@register("string::uppercase")
def uppercase(ctx, s):
    return _s(s).upper()


@register("string::matches")
def matches(ctx, s, pattern):
    if isinstance(pattern, re.Pattern):
        return pattern.search(_s(s)) is not None
    return re.search(_s(pattern, "string::matches"), _s(s)) is not None


@register("string::repeat")
def repeat(ctx, s, n):
    return _s(s) * int(n)


@register("string::replace")
def replace(ctx, s, old, new):
    if isinstance(old, re.Pattern):
        return old.sub(new, _s(s))
    return _s(s).replace(_s(old), _s(new))


@register("string::reverse")
def reverse(ctx, s):
    return _s(s)[::-1]


@register("string::slice")
def slice_(ctx, s, start=None, length=None):
    s = _s(s)
    st = int(start) if start is not None else 0
    if st < 0:
        st += len(s)
    if length is None:
        return s[st:]
    n = int(length)
    if n < 0:
        return s[st:n]
    return s[st : st + n]


@register("string::split")
def split(ctx, s, sep):
    return _s(s).split(_s(sep))


@register("string::trim")
def trim(ctx, s):
    return _s(s).strip()


@register("string::words")
def words(ctx, s):
    return _s(s).split()


@register("string::html::encode")
def html_encode(ctx, s):
    import html

    return html.escape(_s(s))


@register("string::html::sanitize")
def html_sanitize(ctx, s):
    return re.sub(r"<[^>]*>", "", _s(s))


# -------------------------------------------------------------- is::
@register("string::is::alphanum")
def is_alphanum(ctx, s):
    return isinstance(s, str) and s.isalnum()


@register("string::is::alpha")
def is_alpha(ctx, s):
    return isinstance(s, str) and s.isalpha()


@register("string::is::ascii")
def is_ascii(ctx, s):
    return isinstance(s, str) and s.isascii()


@register("string::is::numeric")
def is_numeric(ctx, s):
    return isinstance(s, str) and s.replace(".", "", 1).lstrip("-").isdigit()


@register("string::is::datetime")
def is_datetime(ctx, s, fmt=None):
    from surrealdb_tpu_torch.sql.value import Datetime

    try:
        Datetime.parse(_s(s))
        return True
    except Exception:
        return False


@register("string::is::email")
def is_email(ctx, s):
    return isinstance(s, str) and re.fullmatch(r"[^@\s]+@[^@\s]+\.[^@\s]+", s) is not None


@register("string::is::hexadecimal")
def is_hexadecimal(ctx, s):
    return isinstance(s, str) and re.fullmatch(r"[0-9a-fA-F]+", s) is not None


@register("string::is::ip")
def is_ip(ctx, s):
    import ipaddress

    try:
        ipaddress.ip_address(_s(s))
        return True
    except ValueError:
        return False


@register("string::is::ipv4")
def is_ipv4(ctx, s):
    import ipaddress

    try:
        ipaddress.IPv4Address(_s(s))
        return True
    except ValueError:
        return False


@register("string::is::ipv6")
def is_ipv6(ctx, s):
    import ipaddress

    try:
        ipaddress.IPv6Address(_s(s))
        return True
    except ValueError:
        return False


@register("string::is::latitude")
def is_latitude(ctx, s):
    try:
        return -90.0 <= float(s) <= 90.0
    except (TypeError, ValueError):
        return False


@register("string::is::longitude")
def is_longitude(ctx, s):
    try:
        return -180.0 <= float(s) <= 180.0
    except (TypeError, ValueError):
        return False


@register("string::is::record")
def is_record(ctx, s, tb=None):
    from surrealdb_tpu_torch.sql.value import Thing

    try:
        t = Thing.parse(_s(s))
        return tb is None or t.tb == str(tb)
    except Exception:
        return False


@register("string::is::semver")
def is_semver(ctx, s):
    return (
        isinstance(s, str)
        and re.fullmatch(r"\d+\.\d+\.\d+(-[0-9A-Za-z.-]+)?(\+[0-9A-Za-z.-]+)?", s)
        is not None
    )


@register("string::is::url")
def is_url(ctx, s):
    return isinstance(s, str) and re.match(r"https?://[^\s]+", s) is not None


@register("string::is::ulid")
def is_ulid(ctx, s):
    return isinstance(s, str) and re.fullmatch(r"[0-9A-HJKMNP-TV-Z]{26}", s) is not None


@register("string::is::uuid")
def is_uuid(ctx, s):
    import uuid as _uuid

    try:
        _uuid.UUID(_s(s))
        return True
    except Exception:
        return False


# -------------------------------------------------------------- semver::
def _semver_parts(s: str):
    core = s.split("-")[0].split("+")[0]
    return [int(x) for x in core.split(".")]


@register("string::semver::compare")
def semver_compare(ctx, a, b):
    pa, pb = _semver_parts(_s(a)), _semver_parts(_s(b))
    return (pa > pb) - (pa < pb)


@register("string::semver::major")
def semver_major(ctx, s):
    return _semver_parts(_s(s))[0]


@register("string::semver::minor")
def semver_minor(ctx, s):
    return _semver_parts(_s(s))[1]


@register("string::semver::patch")
def semver_patch(ctx, s):
    return _semver_parts(_s(s))[2]


@register("string::semver::inc::major")
def semver_inc_major(ctx, s):
    p = _semver_parts(_s(s))
    return f"{p[0] + 1}.0.0"


@register("string::semver::inc::minor")
def semver_inc_minor(ctx, s):
    p = _semver_parts(_s(s))
    return f"{p[0]}.{p[1] + 1}.0"


@register("string::semver::inc::patch")
def semver_inc_patch(ctx, s):
    p = _semver_parts(_s(s))
    return f"{p[0]}.{p[1]}.{p[2] + 1}"


@register("string::semver::set::major")
def semver_set_major(ctx, s, v):
    p = _semver_parts(_s(s))
    return f"{int(v)}.{p[1]}.{p[2]}"


@register("string::semver::set::minor")
def semver_set_minor(ctx, s, v):
    p = _semver_parts(_s(s))
    return f"{p[0]}.{int(v)}.{p[2]}"


@register("string::semver::set::patch")
def semver_set_patch(ctx, s, v):
    p = _semver_parts(_s(s))
    return f"{p[0]}.{p[1]}.{int(v)}"


# -------------------------------------------------------------- similarity / distance
def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@register("string::distance::levenshtein")
def distance_levenshtein(ctx, a, b):
    return _levenshtein(_s(a), _s(b))


@register("string::distance::damerau_levenshtein")
def distance_damerau(ctx, a, b):
    a, b = _s(a), _s(b)
    # optimal string alignment variant
    d = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i in range(len(a) + 1):
        d[i][0] = i
    for j in range(len(b) + 1):
        d[0][j] = j
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1, d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[len(a)][len(b)]


@register("string::distance::hamming")
def distance_hamming(ctx, a, b):
    a, b = _s(a), _s(b)
    if len(a) != len(b):
        raise InvalidArgumentsError(
            "string::distance::hamming", "The two strings must be of the same length."
        )
    return sum(x != y for x, y in zip(a, b))


def _jaro(a: str, b: str) -> float:
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    window = max(len(a), len(b)) // 2 - 1
    window = max(window, 0)
    ma = [False] * len(a)
    mb = [False] * len(b)
    matches = 0
    for i, ca in enumerate(a):
        lo = max(0, i - window)
        hi = min(len(b), i + window + 1)
        for j in range(lo, hi):
            if not mb[j] and b[j] == ca:
                ma[i] = mb[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = 0
    k = 0
    for i in range(len(a)):
        if ma[i]:
            while not mb[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    t //= 2
    m = matches
    return (m / len(a) + m / len(b) + (m - t) / m) / 3


@register("string::similarity::jaro")
def similarity_jaro(ctx, a, b):
    return _jaro(_s(a), _s(b))


@register("string::similarity::jaro_winkler")
def similarity_jaro_winkler(ctx, a, b):
    a, b = _s(a), _s(b)
    j = _jaro(a, b)
    prefix = 0
    for x, y in zip(a[:4], b[:4]):
        if x == y:
            prefix += 1
        else:
            break
    return j + prefix * 0.1 * (1 - j)


@register("string::similarity::fuzzy")
def similarity_fuzzy(ctx, a, b):
    # fuzzy score ~ smith-waterman-ish: use normalized levenshtein similarity
    a, b = _s(a), _s(b)
    if not a and not b:
        return 0
    dist = _levenshtein(a.lower(), b.lower())
    longest = max(len(a), len(b))
    return int((1 - dist / longest) * longest * 10)


@register("string::similarity::smithwaterman")
def similarity_smithwaterman(ctx, a, b):
    a, b = _s(a), _s(b)
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    best = 0
    for ca in a:
        cur = [0]
        for j, cb in enumerate(b, 1):
            score = max(0, prev[j - 1] + (2 if ca == cb else -1), prev[j] - 1, cur[j - 1] - 1)
            cur.append(score)
            best = max(best, score)
        prev = cur
    return best


# late additions (reference fnc/mod.rs name set)
@register("string::slug")
def slug(ctx, s):
    import re as _re
    import unicodedata as _ud

    s = _s(s, "string::slug")
    s = _ud.normalize("NFKD", s).encode("ascii", "ignore").decode()
    s = _re.sub(r"[^a-zA-Z0-9]+", "-", s).strip("-").lower()
    return s


@register("string::is::domain")
def is_domain(ctx, s):
    import re as _re

    s = _s(s, "string::is::domain")
    if not s or len(s) > 253:
        return False
    return bool(
        _re.fullmatch(
            r"(?:[a-zA-Z0-9](?:[a-zA-Z0-9-]{0,61}[a-zA-Z0-9])?\.)+[a-zA-Z]{2,63}", s
        )
    )


@register("string::distance::normalized_levenshtein")
def norm_levenshtein(ctx, a, b):
    """Normalized SIMILARITY in [0,1]: 1 - d/max (strsim semantics the
    reference wraps — identical strings give 1.0, empty/empty gives 1.0)."""
    a = _s(a, "string::distance::normalized_levenshtein")
    b = _s(b, "string::distance::normalized_levenshtein")
    if not a and not b:
        return 1.0
    return 1.0 - _levenshtein(a, b) / max(len(a), len(b))


@register("string::distance::normalized_damerau_levenshtein")
def norm_damerau(ctx, a, b):
    a = _s(a, "string::distance::normalized_damerau_levenshtein")
    b = _s(b, "string::distance::normalized_damerau_levenshtein")
    if not a and not b:
        return 1.0
    return 1.0 - distance_damerau(ctx, a, b) / max(len(a), len(b))


@register("string::distance::osa_distance")
def osa_distance(ctx, a, b):
    """Optimal string alignment: damerau-levenshtein with non-overlapping
    transpositions (the classic OSA recurrence)."""
    a = _s(a, "string::distance::osa_distance")
    b = _s(b, "string::distance::osa_distance")
    la, lb = len(a), len(b)
    prev2, prev, cur = None, list(range(lb + 1)), [0] * (lb + 1)
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (
                prev2 is not None
                and i > 1
                and j > 1
                and a[i - 1] == b[j - 2]
                and a[i - 2] == b[j - 1]
            ):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
        prev2, prev = prev, cur
    return prev[lb]


@register("string::similarity::sorensen_dice")
def sorensen_dice(ctx, a, b):
    """Bigram Sørensen–Dice coefficient over non-whitespace characters
    (strsim filters whitespace before building bigrams)."""
    a = "".join(_s(a, "string::similarity::sorensen_dice").split())
    b = "".join(_s(b, "string::similarity::sorensen_dice").split())
    if a == b:
        return 1.0
    if len(a) < 2 or len(b) < 2:
        return 0.0
    from collections import Counter

    ba = Counter(a[i : i + 2] for i in range(len(a) - 1))
    bb = Counter(b[i : i + 2] for i in range(len(b) - 1))
    inter = sum((ba & bb).values())
    return 2.0 * inter / (sum(ba.values()) + sum(bb.values()))
