"""The daemon's span record (``kma_tpu_torch.tracing``) on the CPU.

A CPU ``TorchDevServer`` (batch 32, its image replaying stand-in
graphs) served from a thread takes pipelined ``dense`` frames on two
connections at once: each request's spans share its id, nest inside
the spans they belong to and follow the order of the request's life;
``dense_ms`` is its dispatch plus resolve; a lock the test holds shows as
``lock_wait``; the chain op's span carries its rows and windows.  The
ring, the card's events (a stand-in clock on the CPU) and the idle
partition are held on their own."""

import contextlib
import io
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from kma_tpu_torch import tracing  # noqa: E402
from kma_tpu_torch.config import Penalties  # noqa: E402
from kma_tpu_torch.devserve import (DevClient, TorchDevServer,  # noqa: E402
                                    _recv, _send)
from kma_tpu_torch.index.format import load_index  # noqa: E402
from kma_tpu_torch.mapping import scan_dense as tsd  # noqa: E402
from kma_tpu_torch.mapping.scan_dense import image_footprint  # noqa: E402

from test_torch_devserve import disk_db  # noqa: E402,F401
from test_torch_graphs import _panel_reads, stand_in_capture  # noqa: E402

PEN = Penalties()
#: a penalty set of its own whose scanner keeps no tie id in its tier-0
#: flat buffer, so that every mapped read goes through the wide tier
WIDE_W1 = PEN.W1 - 1
#: a penalty set whose first resolve raises
RAISE_W1 = PEN.W1 - 2


def _meta(W1=PEN.W1, pipeline=True):
    return {"op": "dense", "M": PEN.M, "MM": PEN.MM, "U": PEN.U, "W1": W1,
            "exhaustive": False, "proxi_frac": None, "pipeline": pipeline}


@contextlib.contextmanager
def _served(prefix, path, graphs=True, budget_mb=None):
    """A CPU daemon (batch 32) served from a thread on ``path``."""
    if budget_mb is not None:
        os.environ["KMA_TPU_DENSE_BUDGET_MB"] = str(budget_mb)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            srv = TorchDevServer(prefix, batch=32, device="cpu")
    finally:
        os.environ.pop("KMA_TPU_DENSE_BUDGET_MB", None)
    if graphs:
        srv.didx.graphs = tsd.StepGraphs(capture=stand_in_capture)
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": path, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    try:
        yield srv
    finally:
        DevClient.connect(prefix, sock_path=path).stop()
        th.join(timeout=30)
        assert not th.is_alive()


def _stream(path, reqs, W1=PEN.W1):
    """Pipelined dense frames, then ``flush``: the replies."""
    s = socket.socket(socket.AF_UNIX)
    s.connect(path)
    try:
        for codes, lengths in reqs:
            _send(s, _meta(W1), [("codes", codes), ("lengths", lengths)])
        _send(s, {"op": "flush"})
        return [_recv(s) for _ in range(len(reqs) + 1)]
    finally:
        s.close()


def _requests(spans):
    """{(conn, seq): [spans]} of the dense requests (with a dispatch)."""
    by = {}
    for s in spans:
        by.setdefault((s.conn, s.seq), []).append(s)
    return {k: v for k, v in by.items()
            if any(s.name == "dispatch" for s in v)}


def _one(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, (name, got)
    return got[0]


@pytest.fixture(scope="module")
def served(disk_db, tmp_path_factory):  # noqa: F811
    """The module's daemon after two connections' pipelined streams (3
    requests of 40 reads each; the second connection's through the wide
    tier) and one resolve that raised: (daemon, prefix, socket, replies
    by connection)."""
    prefix, _ = disk_db
    path = str(tmp_path_factory.mktemp("trace") / "d.sock")
    with _served(prefix, path) as srv:
        srv._scanner(_meta(WIDE_W1)).flat_headroom = 0
        sc = srv._scanner(_meta(RAISE_W1))
        resolve, raised = sc.scan_resolve, []

        def scan_resolve(h):
            if not raised:
                raised.append(1)
                raise RuntimeError("a resolve that raised")
            return resolve(h)

        sc.scan_resolve = scan_resolve
        replies = {}

        def client(name, W1, seed):
            reqs = [_panel_reads(prefix, 40, seed + i) for i in range(3)]
            replies[name] = _stream(path, reqs, W1)

        ths = [threading.Thread(target=client, args=a)
               for a in (("plain", PEN.W1, 10), ("wide", WIDE_W1, 20))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
        replies["raised"] = _stream(path, [_panel_reads(prefix, 40, 30)],
                                    RAISE_W1)
        yield srv, prefix, path, replies


def _inside(s, p):
    return p.t0 <= s.t0 <= s.t1 <= p.t1


def test_dense_spans_nest_in_order(served):
    """Every dense request's spans share its id (its connection and
    frame), nest inside the spans they belong to, and follow the
    request's life: recv, lock_wait, dispatch (upload and device a
    batch), lock_wait, resolve (device_wait; upload and device a wide
    chunk), pack."""
    srv, _, _, replies = served
    assert all(rm["ok"] == 1 for rm, _ in replies["plain"] + replies["wide"])
    spans = srv.spans.snapshot()
    # the fixture's streams: its two clients, then the one that raised
    reqs = {k: v for k, v in _requests(spans).items() if k[0] < 2}
    assert sorted(reqs) == [(c, q) for c in (0, 1) for q in range(3)]
    widened = 0
    for key, ss in reqs.items():
        recv, disp, res, pack = (_one(ss, n) for n in (
            "recv", "dispatch", "resolve", "pack"))
        waits = sorted((s for s in ss if s.name == "lock_wait"),
                       key=lambda s: s.t0)
        assert len(waits) == 2
        order = [recv, waits[0], disp, waits[1], res, pack]
        for a, b in zip(order, order[1:]):
            assert a.t1 <= b.t0, (a, b)
        assert {s.name for s in ss} <= {"recv", "lock_wait", "dispatch",
                                        "upload", "device", "resolve",
                                        "device_wait", "pack"}
        # a batch's upload, then its step (on the CPU a device span is
        # the host interval of the eager step), in the dispatch for
        # tier 0 and in the resolve for a wide chunk
        batches = sorted((s for s in ss if s.name in ("upload", "device")),
                         key=lambda s: (s.t0, s.name != "upload"))
        assert [s.name for s in batches] == ["upload", "device"] * (
            len(batches) // 2)
        for up, dev in zip(batches[::2], batches[1::2]):
            assert up.t1 <= dev.t0
            assert _inside(up, disp) and _inside(dev, disp) or \
                _inside(up, res) and _inside(dev, res)
        assert [s.name for s in batches if _inside(s, disp)] == [
            "upload", "device"] * 2
        waits_dev = [s for s in ss if s.name == "device_wait"]
        assert waits_dev and all(_inside(s, res) for s in waits_dev)
        if len(batches) > 4:
            widened += 1
            # each chunk's outputs are waited for after its step
            chunks = [s for s in batches[4:] if s.name == "device"]
            assert len(waits_dev) == 1 + len(chunks)
            for dev, w in zip(chunks, sorted(waits_dev, key=lambda s: s.t0)
                              [1:]):
                assert dev.t1 <= w.t0
    assert widened == 3


def test_dense_ms_is_dispatch_plus_resolve(served):
    """``dense_ms`` is each request's dispatch plus resolve ms, in
    resolve order, the resolve that raised included; read only."""
    srv, _, _, replies = served
    (bad, _), (flushed, _) = replies["raised"]
    assert bad["ok"] == 0 and "a resolve that raised" in bad["err"]
    assert flushed["ok"] == 1
    spans = srv.spans.snapshot()
    reqs = _requests(spans)
    want = [1e3 * (s.t1 - s.t0 + _one(reqs[(s.conn, s.seq)],
                                      "dispatch").t1
                   - _one(reqs[(s.conn, s.seq)], "dispatch").t0)
            for s in spans if s.name == "resolve"]
    got = list(srv.dense_ms)
    assert len(got) == len(srv.dense_ms) == len(want) >= 7
    assert np.allclose(got, want, rtol=0, atol=1e-5)
    assert srv.dense_ms[2:5] == got[2:5] and srv.dense_ms[-1] == got[-1]
    # the request whose resolve raised: in dense_ms, with no pack
    (bad,) = [v for k, v in reqs.items() if k[0] == 2]
    assert not any(s.name == "pack" for s in bad)
    res = _one(bad, "resolve")
    assert [s.id for s in spans if s.name == "resolve"].index(res.id) \
        < len(got)
    assert not hasattr(srv.dense_ms, "append")
    assert not hasattr(srv, "chain_ms")


def test_held_lock_shows_as_lock_wait(served):
    """A request that arrives while the test holds the op lock waits at
    least as long as the lock is held after it arrived."""
    srv, prefix, path, _ = served
    codes, lengths = _panel_reads(prefix, 20, 40)
    cli = DevClient.connect(prefix, sock_path=path)
    out = []
    n0 = srv.spans.n

    def arrived():
        """A frame received with no other span of its request yet: the
        dense request, waiting for the lock."""
        ss = [s for s in srv.spans.snapshot() if s.id >= n0]
        return any(s.name == "recv" and not any(
            (o.conn, o.seq) == (s.conn, s.seq) and o is not s for o in ss)
            for s in ss)

    with srv.op_lock:
        th = threading.Thread(target=lambda: out.append(cli.dense_scan(
            codes, lengths, PEN, False, None)))
        th.start()
        deadline = time.time() + 30
        while not arrived():
            assert time.time() < deadline
            time.sleep(0.01)
        t_held = time.perf_counter()
        time.sleep(0.3)
        t_free = time.perf_counter()
    th.join(timeout=30)
    cli.close()
    assert out and len(out[0][0]) == 20
    ss = max(_requests(srv.spans.snapshot()).values(),
             key=lambda v: v[0].id)
    wait = _one(ss, "lock_wait")
    assert wait.t0 <= t_held and wait.t1 >= t_free
    assert wait.t1 - wait.t0 >= 0.3


def test_chain_span_carries_rows_and_windows(served):
    srv, prefix, path, _ = served
    codes, lengths = _panel_reads(prefix, 12, 50)
    cli = DevClient.connect(prefix, sock_path=path)
    rows_f, _ = cli.chain_lookup(codes, lengths)
    cli.close()
    spans = srv.spans.snapshot()
    chain = [s for s in spans if s.name == "chain"]
    assert chain and (chain[-1].a, chain[-1].b) == rows_f.shape
    ss = [s for s in spans
          if (s.conn, s.seq) == (chain[-1].conn, chain[-1].seq)]
    assert sorted(s.name for s in ss) == ["chain", "lock_wait", "recv"]


def test_ring_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 8)
    rec = tracing.Recorder(torch.device("cpu"))
    for i in range(6):
        rec.add((tracing.RECV, float(i), i + 0.5, 0, i, 0, 0))
    rec.add(*[(tracing.RESOLVE if i % 2 else tracing.RECV, float(i),
               i + 0.5, 0, i, 0, 0) for i in range(6, 12)])
    assert rec.dropped == 4 and rec.lost_until == 3.5
    snap = rec.snapshot()
    assert [s.id for s in snap] == list(range(4, 12))
    assert [s.seq for s in snap] == list(range(4, 12))
    assert rec.resolves == 3 == len(tracing.DenseMs(rec))
    # a resolve the ring drops leaves dense_ms
    rec.add(*[(tracing.RECV, 20.0, 20.5, 0, 12, 0, 0)] * 4)
    assert rec.resolves == 2 == len(tracing.DenseMs(rec))
    assert rec.dropped == 8 and rec.lost_until == 7.5
    rec.reset()
    assert rec.snapshot() == [] and rec.dropped == 0


class StandInClock:
    """What the card's clock is to the record: an event's host time at
    its record stands in for the card's timestamp; handles are pooled."""

    def __init__(self):
        self.at, self.pool, self.out = {}, [], 0

    def stamp(self):
        h = self.pool.pop() if self.pool else len(self.at)
        self.at[h] = time.perf_counter()
        self.out += 1
        return h

    def done(self, h):
        return True

    def host_s(self, h):
        return self.at[h]

    def give(self, handles):
        self.pool.extend(handles)
        self.out -= len(handles)


def test_events_leave_the_record_at_resolve(disk_db, tmp_path):  # noqa: F811
    """With the card's events (a stand-in clock on the CPU) each batch's
    device span runs from the step's return to an event after the step,
    and once a request resolves no event is out of the pool and the
    rows hold numbers alone."""
    prefix, _ = disk_db
    with _served(prefix, str(tmp_path / "e.sock"), graphs=False) as srv:
        clock = srv.spans.clock = StandInClock()
        _stream(str(tmp_path / "e.sock"),
                [_panel_reads(prefix, 40, s) for s in (60, 61)])
    # two requests in flight at once, two batches each
    assert clock.out == 0 and len(clock.pool) == 4
    spans = srv.spans.snapshot()
    for ss in _requests(spans).values():
        dev = sorted((s for s in ss if s.name == "device"),
                     key=lambda s: s.t0)
        up = sorted((s for s in ss if s.name == "upload"),
                    key=lambda s: s.t0)
        disp = _one(ss, "dispatch")
        assert len(dev) == len(up) == 2
        assert up[0].t1 <= dev[0].t0 <= dev[0].t1 <= up[1].t0
        assert up[1].t1 <= dev[1].t0 <= dev[1].t1 <= disp.t1
    assert all(isinstance(x, (int, float)) for s in spans for x in s[2:])


def test_pair_stream_requests_carry_the_same_spans(disk_db,  # noqa: F811
                                                   tmp_path):
    prefix, _ = disk_db
    fp = image_footprint(load_index(prefix), 1, 32)[0].total
    with _served(prefix, str(tmp_path / "p.sock"), graphs=False,
                 budget_mb=(fp >> 20) - 1) as srv:
        assert srv.scanner_kind == "pair_stream"
        replies = _stream(str(tmp_path / "p.sock"),
                          [_panel_reads(prefix, 40, s) for s in (70, 71)])
    assert all(rm["ok"] == 1 for rm, _ in replies)
    reqs = _requests(srv.spans.snapshot())
    assert len(reqs) == 2
    for ss in reqs.values():
        names = sorted(s.name for s in ss)
        assert names == sorted(
            ["recv", "lock_wait", "dispatch", "lock_wait", "resolve",
             "device_wait", "pack"] + ["upload", "device"] * 2)
    assert len(srv.dense_ms) == 2


def _span(i, name, t0, t1, conn=0):
    return tracing.Span(i, name, t0, t1, conn, 0, 0, 0)


def test_idle_partition_by_hand():
    """Window [0, 10]: the card busy [0, 2] and [5, 6]; connection 0 a
    dense request (recv [2, 2.5], lock_wait [2.5, 3], dispatch [3, 4],
    resolve [6, 8] holding a device_wait [6, 7], pack [8, 8.5]);
    connection 1 receiving [9, 9.5].  Idle 7 s: under the lock [3, 4]
    and [7, 8.5] (2.5), receiving [2, 2.5] and [9, 9.5] (1), no request
    [4, 5], [8.5, 9], [9.5, 10] (2), other [2.5, 3] and [6, 7] (1.5)."""
    spans = [_span(0, "device", 0, 2), _span(1, "recv", 2, 2.5),
             _span(2, "lock_wait", 2.5, 3), _span(3, "dispatch", 3, 4),
             _span(4, "device", 5, 6), _span(5, "resolve", 6, 8),
             _span(6, "device_wait", 6, 7), _span(7, "pack", 8, 8.5),
             _span(8, "recv", 9, 9.5, conn=1)]
    sp = tracing.idle_split(spans, 0.0, 10.0)
    assert sp == pytest.approx({"idle": 7.0, "under_lock": 2.5,
                                "receiving": 1.0, "no_request": 2.0,
                                "other": 1.5}, abs=1e-12)
    # clipped to a part of the window
    sp = tracing.idle_split(spans, 3.5, 9.0)
    assert sp == pytest.approx({"idle": 4.5, "under_lock": 2.0,
                                "receiving": 0.0, "no_request": 1.5,
                                "other": 1.0}, abs=1e-12)
    rec = tracing.Recorder(torch.device("cpu"))
    rec.add(*[(tracing.NAMES.index(s.name), s.t0, s.t1, s.conn, s.seq, s.a,
               s.b) for s in spans])
    # the line's window runs from the first span to the last, [0, 9.5]
    assert tracing.span_line(rec) == (
        "dense 1 requests; medians lock wait 500.0 ms, upload 0.0 ms, "
        "resolve host 1500.0 ms; card idle 68.4 %: under the lock 26.3, "
        "receiving 10.5, no request 15.8, other 15.8")
