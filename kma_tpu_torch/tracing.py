"""The daemon's span record: where each request's time goes, on the
host's clock, with the card's batches timed by CUDA events.

Each ``TorchDevServer`` owns a ``Recorder`` (``srv.spans``);
``latest()`` is the recorder of the newest daemon built in the process.
A span is one row of a ring of ``CAPACITY`` rows, allocated once:
(name, start s, end s, connection, frame, a, b).  A span's id is its
number among the recorder's spans; a request is (connection, frame):
the daemon's number of the connection and the frame's sequence on it
(connection -1: a dense request made outside the serve loop).  ``a``
and ``b`` are integer attributes.  When the ring is full the oldest
span goes; ``dropped`` counts them and ``lost_until`` is the latest end
among them.

The spans of a ``dense`` request, in order (the serve loop, the
daemon's ``_dense_dispatch`` and ``_dense_pack``, the scanners):

- ``recv``: the frame's first header byte to its last array byte;
- ``lock_wait``: wanting the daemon's op lock to holding it;
- ``dispatch``, with an ``upload`` (the batch padded and copied to the
  device) for each tier-0 batch;
- ``device``: each batch's step on the card, tier 0 and each wide
  chunk, from the host's return from the step's call (a replay's
  graph launch, 0.7-1.2 ms of host time on the H100's host, which no
  event on the stream sees) to a CUDA event on the primary card's
  stream after the step, placed on the host clock against one anchor
  event (``CardClock``).  Work the card still holds at the return
  (an earlier batch) is busy time too, so the spans' union is the
  card's busy time but for work that starts inside the launch.  On the
  CPU the span is the host interval of the eager step;
- ``lock_wait`` again, then ``resolve`` (b: the request's dispatch ns),
  with ``device_wait`` (the outputs' copies to the host, which wait for
  the card) and, where reads go through the wide tier, its chunks'
  ``upload`` and ``device_wait``;
- ``pack``: the tie lists packed and the reply's arrays.

Every other op records ``recv``, ``lock_wait`` and one span named for
the op (``chain``: a rows, b windows).  The record is always on; it
syncs nothing on the card, and a request that has resolved leaves no
tensor or event in it.  ``DenseMs`` is the daemon's ``dense_ms``:
dispatch plus resolve ms of each request, in resolve order.
``span_line`` is the operator's summary at the daemon's stop.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from collections.abc import Sequence
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

#: spans the ring holds: ~20 a dense request of 8 batches, so a 51 s
#: window of the samples cell (~2,500 requests) is a fifth of it
CAPACITY = 1 << 18

NAMES = ("recv", "lock_wait", "dispatch", "upload", "device", "resolve",
         "device_wait", "pack", "hello", "chain", "nw", "nw_codes",
         "nw_qext", "pileup")
(RECV, LOCK_WAIT, DISPATCH, UPLOAD, DEVICE, RESOLVE, DEVICE_WAIT,
 PACK) = range(8)
#: the code of each op's span
OPS = {n: i for i, n in enumerate(NAMES) if i > PACK}

#: one span as ``Recorder.snapshot`` gives it
Span = collections.namedtuple("Span", "id name t0 t1 conn seq a b")

_local = threading.local()
_latest: List["Recorder"] = []
_NULL = nullcontext()


def latest() -> Optional["Recorder"]:
    """The recorder of the newest daemon built in this process."""
    return _latest[0] if _latest else None


def current() -> Optional["Request"]:
    """The request this thread is serving, or None."""
    return getattr(_local, "req", None)


def span(name: int, a: int = 0, b: int = 0):
    """A span of the current request around a ``with`` block (nothing
    outside a request)."""
    req = getattr(_local, "req", None)
    return _NULL if req is None else _Span(req, name, a, b)


def annotate(a: int, b: int = 0) -> None:
    """Set the attributes of the current request's innermost span."""
    req = getattr(_local, "req", None)
    if req is not None and req.top is not None:
        req.top.a, req.top.b = a, b


class Recorder:
    """The ring of one daemon's spans; ``lock`` guards its rows (the
    daemon's stats lock)."""

    def __init__(self, device, lock: Optional[threading.Lock] = None):
        self.device = device
        self._cpu = device.type != "cuda"
        self.capacity = CAPACITY
        self._lock = lock or threading.Lock()
        self._rows: list = [None] * self.capacity
        #: spans written, the ring's dropped spans and the latest end
        #: among them, the resolve spans it holds
        self.n = 0
        self.dropped = 0
        self.lost_until = float("-inf")
        self.resolves = 0
        self._frames = 0
        #: the card's events once serving (``anchor``)
        self.clock: Optional[CardClock] = None
        _latest[:] = [self]

    def add(self, *rows: tuple) -> None:
        """Write ended spans, each (name, t0, t1, conn, seq, a, b)."""
        with self._lock:
            cap, ring, n = self.capacity, self._rows, self.n
            for i, row in enumerate(rows, n):
                old = ring[i % cap]
                if i >= cap:                # the ring drops its oldest
                    self.dropped += 1
                    if old[2] > self.lost_until:
                        self.lost_until = old[2]
                    if old[0] == RESOLVE:
                        self.resolves -= 1
                if row[0] == RESOLVE:
                    self.resolves += 1
                ring[i % cap] = row
            self.n = n + len(rows)

    def reset(self) -> None:
        """Forget every span (no request in flight)."""
        with self._lock:
            self._rows = [None] * self.capacity
            self.n = self.dropped = self.resolves = 0
            self.lost_until = float("-inf")

    def _held(self):
        """The held rows with their ids, oldest first (held lock)."""
        cap, rows = self.capacity, self._rows
        for i in range(max(0, self.n - cap), self.n):
            yield i, rows[i % cap]

    def snapshot(self) -> List[Span]:
        """Every span the ring holds, by id, names as strings."""
        with self._lock:
            return [Span(i, NAMES[r[0]], *r[1:]) for i, r in self._held()]

    def request(self, conn: int = -1, seq: Optional[int] = None
                ) -> "Request":
        """A request's handle: (conn, seq), or a request made outside the
        serve loop (connection -1, numbered by the recorder)."""
        if seq is None:
            with self._lock:
                seq = self._frames
                self._frames += 1
        return Request(self, conn, seq)

    def anchor(self) -> None:
        """On a card, start timing its work (``CardClock``)."""
        if not self._cpu:
            self.clock = CardClock(self.device)


class CardClock:
    """CUDA events on the primary card's current stream, placed on the
    host clock against one anchor event.  They are recorded, queried and
    read by libcuda's own calls (``cuEventRecord``, ``cuEventQuery``,
    ``cuEventElapsedTime``, by ctypes): on the H100's host a call through
    ``torch.cuda.Event`` cost 4.5 (record) and 6.8 (elapsed) us, libcuda's
    own 3.4 and 3.6.  The events are ``torch.cuda.Event`` objects (the
    clock owns them), pooled.  Every call is made under the daemon's op
    lock, so that no query meets another connection's graph capture."""

    def __init__(self, device):
        import ctypes

        import torch
        self.stream = torch.cuda.current_stream(device)
        cu = ctypes.CDLL("libcuda.so.1")
        vp = ctypes.c_void_p
        self._record, self._query, self._elapsed = (
            cu.cuEventRecord, cu.cuEventQuery, cu.cuEventElapsedTime)
        self._record.argtypes = (vp, vp)
        self._query.argtypes = (vp,)
        self._elapsed.argtypes = (ctypes.POINTER(ctypes.c_float), vp, vp)
        for f in (self._record, self._query, self._elapsed):
            f.restype = ctypes.c_int
        self._ms = ctypes.c_float()
        self._ms_p = ctypes.byref(self._ms)
        self._events: list = []
        self._pool: list = []
        #: events held by requests not yet resolved
        self.out = 0
        # the anchor: one event on the idle stream, synchronised (the
        # tightest of 5 tries), stands at the midpoint of its record and
        # its sync
        best = None
        for _ in range(5):
            self.stream.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev.record(self.stream)
            ev.synchronize()
            t1 = time.perf_counter()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (ev, t0, t1)
        self._events.append(best[0])
        self._anchor = best[0].cuda_event
        self._anchor_s = (best[1] + best[2]) / 2

    def stamp(self) -> int:
        """The handle of an event recorded now."""
        if self._pool:
            h = self._pool.pop()
        else:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)          # creates its handle
            self._events.append(ev)
            h = ev.cuda_event
        rc = self._record(h, self.stream.cuda_stream)
        if rc:
            raise RuntimeError("cuEventRecord: CUDA error %d" % rc)
        self.out += 1
        return h

    def done(self, h: int) -> bool:
        return self._query(h) == 0

    def host_s(self, h: int) -> float:
        """The host time of a completed event."""
        rc = self._elapsed(self._ms_p, self._anchor, h)
        if rc:
            raise RuntimeError("cuEventElapsedTime: CUDA error %d" % rc)
        return self._anchor_s + self._ms.value / 1e3

    def give(self, handles) -> None:
        """Events back to the pool."""
        self._pool.extend(handles)
        self.out -= len(handles)


class _Span:
    """A span around a ``with`` block: the request is this thread's
    current one inside it.  Its row, and those of the spans inside it,
    are written when the outermost ends."""

    __slots__ = ("req", "name", "a", "b", "t0", "t1", "up", "prev")

    def __init__(self, req: "Request", name: int, a: int, b: int):
        self.req, self.name, self.a, self.b = req, name, a, b

    def __enter__(self):
        req = self.req
        self.prev = getattr(_local, "req", None)
        _local.req = req
        self.up, req.top = req.top, self
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        req = self.req
        req.top = self.up
        _local.req = self.prev
        req.rows.append((self.name, self.t0, self.t1, req.conn, req.seq,
                         self.a, self.b))
        if self.up is None:
            rows, req.rows = req.rows, []
            req.rec.add(*rows)
        return False


class _Under:
    """Wait for ``lock`` (a ``lock_wait`` span), then hold it with the
    request current."""

    __slots__ = ("req", "lock", "prev")

    def __init__(self, req: "Request", lock):
        self.req, self.lock = req, lock

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.acquire()
        req = self.req
        # written with the next span that ends (or ``settle``)
        req.rows.append((LOCK_WAIT, t0, time.perf_counter(), req.conn,
                         req.seq, 0, 0))
        self.prev = getattr(_local, "req", None)
        _local.req = req
        return req

    def __exit__(self, *exc):
        _local.req = self.prev
        self.lock.release()
        return False


class Request:
    """One request's handle: its id, its innermost open span, its spans
    until the outermost around them ends, and the CUDA event of each of
    its batches until it resolves."""

    __slots__ = ("rec", "conn", "seq", "top", "rows", "events",
                 "dispatch_ns")

    def __init__(self, rec: Recorder, conn: int, seq: int):
        self.rec, self.conn, self.seq = rec, conn, seq
        self.top = None
        self.rows: list = []
        #: (host s of the step call's return, end event) of each batch
        #: queued on the card
        self.events: list = []
        self.dispatch_ns = 0

    def add(self, name: int, t0: float, t1: float) -> None:
        """A span of the request outside any other."""
        self.rec.add((name, t0, t1, self.conn, self.seq, 0, 0))

    def span(self, name: int, a: int = 0, b: int = 0) -> _Span:
        return _Span(self, name, a, b)

    def under(self, lock) -> _Under:
        return _Under(self, lock)

    def step(self, t0: float, call, args):
        """``call(*args)``, one batch's step whose inputs took from
        ``t0`` until now to pad and upload: its ``upload`` span, and its
        ``device`` span: on a card from the call's return to an event
        after the step; on the CPU the step's host interval."""
        t1 = time.perf_counter()
        self.rows.append((UPLOAD, t0, t1, self.conn, self.seq, 0, 0))
        out = call(*args)
        t2 = time.perf_counter()
        clock = self.rec.clock
        if clock is not None:
            self.events.append((t2, clock.stamp()))
        elif self.rec._cpu:
            self.rows.append((DEVICE, t1, t2, self.conn, self.seq, 0, 0))
        return out

    def settle(self, synced: bool = False) -> None:
        """Write the request's last spans, its ``device`` spans from their
        events once the resolve has ``synced`` on them (else those whose
        end has come: a resolve that raised, a client that left), and give
        the events back."""
        rec, rows, evs = self.rec, self.rows, self.events
        if evs:
            clock = rec.clock
            for t, e in evs:
                if synced or clock.done(e):
                    t1 = clock.host_s(e)
                    rows.append((DEVICE, min(t, t1), t1, self.conn,
                                 self.seq, 0, 0))
            clock.give([e for _, e in evs])
            self.events = []
        if rows:
            self.rows = []
            rec.add(*rows)


class DenseMs(Sequence):
    """The daemon's ``dense_ms``, read only: dispatch plus resolve wall ms
    of each dense request the ring holds, in resolve order (a resolve
    that raised included)."""

    def __init__(self, rec: Recorder):
        self._rec = rec

    def _values(self) -> List[float]:
        rec = self._rec
        with rec._lock:
            return [1e3 * (r[2] - r[1]) + r[6] / 1e6
                    for _, r in rec._held() if r[0] == RESOLVE]

    def __len__(self) -> int:
        with self._rec._lock:
            return self._rec.resolves

    def __getitem__(self, i):
        return self._values()[i]

    def __iter__(self):
        return iter(self._values())


# -- the operator's summary ---------------------------------------------------

def _union(ivs) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _minus(xs, ys) -> List[Tuple[float, float]]:
    """xs less ys, both unions."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def _inter(xs, ys) -> List[Tuple[float, float]]:
    return _minus(xs, _minus(xs, ys))


def _length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def idle_split(spans: List[Span], w0: float, w1: float) -> Dict[str, float]:
    """Seconds of [w0, w1] with no ``device`` span open (``idle``), split
    by what the daemon did meanwhile: ``under_lock`` (a connection held
    the op lock in a dispatch, resolve, pack or op, outside its
    ``device_wait``), ``receiving`` (else a frame was arriving),
    ``no_request`` (no connection in recv, lock_wait, dispatch, resolve,
    pack or an op: the daemon waited on its clients) and ``other``."""
    ops = set(OPS)

    def iv(names):
        return _union((max(s.t0, w0), min(s.t1, w1)) for s in spans
                      if s.name in names)

    held = {"dispatch", "resolve", "pack"} | ops
    idle = _minus([(w0, w1)], iv({"device"}))
    lock = _minus(iv(held), iv({"device_wait"}))
    under = _inter(idle, lock)
    recv = _inter(_minus(idle, lock), iv({"recv"}))
    none = _minus(idle, iv(held | {"recv", "lock_wait"}))
    out = {"idle": _length(idle), "under_lock": _length(under),
           "receiving": _length(recv), "no_request": _length(none)}
    out["other"] = max(0.0, out["idle"] - out["under_lock"]
                       - out["receiving"] - out["no_request"])
    return out


def request_sums(spans: List[Span]) -> Dict[tuple, Dict[str, float]]:
    """Seconds of each span name summed by dense request (those with a
    dispatch), keyed (conn, seq)."""
    by: Dict[tuple, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for s in spans:
        by[(s.conn, s.seq)][s.name] += s.t1 - s.t0
    return {k: v for k, v in by.items() if "dispatch" in v}


def span_line(rec: Recorder) -> str:
    """``dense 67 requests; medians lock wait 2140.3 ms, upload 612.8 ms,
    resolve host 21.4 ms; card idle 9.8 %: under the lock 7.1, receiving
    0.2, no request 0.4, other 2.1``: the dense requests the ring holds,
    the medians over them of their two lock waits, their batches'
    uploads and their resolve less its device waits plus the packing,
    and the card's idle share of the span from the first span to the
    last (``idle_split``); ``, dropped N spans`` where the ring dropped
    any."""
    spans = rec.snapshot()
    reqs = list(request_sums(spans).values())
    line = "dense %d requests" % len(reqs)
    if reqs:
        def med(f):
            return 1e3 * statistics.median(f(r) for r in reqs)
        line += ("; medians lock wait %.1f ms, upload %.1f ms, resolve host "
                 "%.1f ms" % (med(lambda r: r["lock_wait"]),
                              med(lambda r: r["upload"]),
                              med(lambda r: r["resolve"] - r["device_wait"]
                                  + r["pack"])))
    if spans:
        w0 = min(s.t0 for s in spans)
        w1 = max(s.t1 for s in spans)
        if w1 > w0:
            sp = idle_split(spans, w0, w1)
            line += "; card idle %.1f %%: %s" % (
                100 * sp["idle"] / (w1 - w0), ", ".join(
                    "%s %.1f" % (name, 100 * sp[k] / (w1 - w0))
                    for name, k in (("under the lock", "under_lock"),
                                    ("receiving", "receiving"),
                                    ("no request", "no_request"),
                                    ("other", "other"))))
    if rec.dropped:
        line += ", dropped %d spans" % rec.dropped
    return line
