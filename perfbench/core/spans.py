"""What the per-layer readers take from a timing_log: each entry ends in
the dict that ``utils/perfmon.Spans.fold`` gave, whose ``spans`` map a
span's name to its (total s, self s, count)."""


def folded_spans(log) -> list:
    """The ``spans`` dict of each entry of `log` (None: no entries)."""
    return [x[-1]["spans"] for x in log or () if isinstance(x[-1], dict)]


def ms_per_count(log, name: str, field: int = 0):
    """A span's total (field 0) or self (field 1) time over the times it
    ran, in ms; None where it never ran."""
    got = [s[name] for s in folded_spans(log) if name in s]
    if not got:
        return None
    return 1e3 * sum(g[field] for g in got) / sum(g[2] for g in got)
