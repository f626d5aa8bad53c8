"""What the readers of the daemon's span record share
(``kma_tpu_torch.tracing``: ``latest()``, the recorder of the newest
daemon the process built; its ``snapshot()``, each span's name, start
and end on the host's clock, request (connection, frame) and
attributes): the record over the part of the window that
``dense_op_ms`` covers, and interval arithmetic of their own, so that
no reader calls the program's summary.

The window starts at the load's last unit's end less ``res.window_s``.
Its requests are the dense requests resolved in it, in resolve order,
as many as ``res.daemon.dense_ms`` holds (where the mix traces its last
``trace_seconds`` alone, those resolved before the profiler started),
and the part ends at the last one's resolve, else at the window's end.
A port without the record, a window whose spans the ring dropped, or a
part with no request gives None."""

from __future__ import annotations

from types import SimpleNamespace

#: the spans of ops other than ``dense``, each held under the op lock
OPS = ("hello", "chain", "nw", "nw_codes", "nw_qext", "pileup")


def part(res):
    """SimpleNamespace(w0, w1, spans, requests {(conn, frame): [spans]}),
    or None."""
    try:
        from kma_tpu_torch import tracing
    except ImportError:
        return None
    rec = tracing.latest()
    runs = getattr(res.load, "runs", None)
    units = runs if isinstance(runs, list) else res.load.rec["units"]
    n = len(res.daemon.dense_ms)
    if rec is None or not units or not n:
        return None
    t_end = max(u["t1"] for u in units)
    w0 = t_end - res.window_s
    if rec.lost_until >= w0:
        return None
    spans = rec.snapshot()
    by = {}
    for s in spans:
        by.setdefault((s.conn, s.seq), []).append(s)
    done = [s for s in spans if s.name == "resolve" and s.t1 > w0]
    w1 = t_end if n >= len(done) else done[n - 1].t1
    requests = {(s.conn, s.seq): by[(s.conn, s.seq)] for s in done[:n]}
    return SimpleNamespace(w0=w0, w1=w1, spans=spans, requests=requests)


def total(ss, *names) -> float:
    """Seconds of a request's spans of these names."""
    return sum(s.t1 - s.t0 for s in ss if s.name in names)


def seconds(p, groups, want) -> float:
    """Seconds of the part in which ``want(n)`` holds, ``n`` the number
    of spans open of each group (``groups``: {group: span names}), by a
    sweep over the spans' ends clipped to the part."""
    ev = []
    for g, names in groups.items():
        for s in p.spans:
            if s.name in names and s.t1 > p.w0 and s.t0 < p.w1:
                ev.append((max(s.t0, p.w0), 1, g))
                ev.append((min(s.t1, p.w1), -1, g))
    ev.sort()
    n = dict.fromkeys(groups, 0)
    t, acc = p.w0, 0.0
    for x, d, g in ev:
        if want(n):
            acc += x - t
        t = x
        n[g] += d
    if want(n):
        acc += p.w1 - t
    return acc


def share(p, groups, want) -> float:
    """``seconds``' % of the part."""
    return 100.0 * seconds(p, groups, want) / (p.w1 - p.w0)
