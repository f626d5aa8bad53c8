"""The dense step's graph cache (``scan_dense.StepGraphs``) on the CPU.

A CUDA graph exists only on the card, so these tests hand the cache a
stand-in capturer that behaves as a graph does for it: one set of static
outputs, written by every replay from the static inputs as they then
hold.  With it a CPU daemon takes the cache's route, and its replies
must equal the eager scanner's and its runs ``-device off``'s bytes
(tolerance 0: every output is an integer).  The card's own graphs are
held in tests/test_torch_cuda.py (marked ``cuda``)."""

import dataclasses
import os
import re
import socket
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kma_tpu_torch import entry as te
from kma_tpu_torch.config import Penalties
from kma_tpu_torch.mapping import scan_dense as tsd
from kma_tpu_torch.ops import scan_kernel as sk

pytest.importorskip("jax")

from test_torch_devserve import _same_outputs, disk_db, native_cli  # noqa: E402,F401,E501

REPO = Path(__file__).resolve().parent.parent


class StandInGraph:
    """What a captured graph is to the cache: ``out`` is written in place
    by each ``replay()`` from the static ``args`` as they then hold."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        self.out = tuple(t.clone() for t in fn(*args))

    def replay(self):
        # a graph replays its kernels, not the wrappers' Python: their
        # counts are the cache's to add
        n = sk.run_score_rows.launches
        for o, r in zip(self.out, self.fn(*self.args)):
            o.copy_(r)
        sk.run_score_rows.launches = n


def stand_in_capture(fn, args, pool=None):
    """``entry.capture``'s contract on the CPU: WARMUP eager calls, then
    a capture whose outputs the replays overwrite."""
    for _ in range(te.WARMUP):
        fn(*args)
    g = StandInGraph(fn, args)
    return g, g.out


@pytest.fixture(scope="module")
def tiny():
    idx, codes, lengths, templates = te.tiny_problem()
    return idx, codes, lengths, templates


def _scanner(idx, **kw):
    return tsd.DenseScanner(idx, kw.pop("pen", Penalties()), batch=8,
                            device="cpu", **kw)


# -- (a) the key --------------------------------------------------------------

def _jax_statics():
    """The static_argnames of the JAX jit of dense_scan_device, read from
    its source."""
    src = (REPO / "kma_tpu" / "mapping" / "scan_dense.py").read_text()
    m = re.search(r"static_argnames=\(([^)]*)\)\)\s*\ndef dense_scan_device",
                  src)
    return set(re.findall(r'"(\w+)"', m.group(1)))


def _varied(name, idx, sc, shape, tier, flat_cap):
    """(image, shape, statics) of a batch of ``shape`` at ``tier`` on
    ``sc`` with the static argument ``name`` (or L) changed."""
    d, (B, L) = sc.didx, shape
    st = sc._statics(L, tier, flat_cap)
    if name == "sparams":
        # the penalty set (with exhaustive and the tier's caps) is in it
        st = dict(st, sparams=_scanner(
            idx, pen=dataclasses.replace(Penalties(), MM=-3)
        )._statics(L, tier, flat_cap)["sparams"])
    elif name == "exhaustive":
        st = dict(st, sparams=_scanner(idx, exhaustive=True)._statics(
            L, tier, flat_cap)["sparams"])
    elif name == "tier":
        st = sc._statics(L, 1 - tier, flat_cap)
    elif name == "B":
        B += 8
    elif name == "L":
        L += 64
        st = sc._statics(L, tier, flat_cap)
    elif name == "flat_cap":
        st = dict(st, flat_cap=flat_cap + 8)
    elif name == "small_ids":
        st = dict(st, small_ids=not st["small_ids"])
    elif name == "proxi_frac":
        st = _scanner(idx, proxi_frac=0.9)._statics(L, tier, flat_cap)
    elif name == "merged":
        st = dict(st, merged=not st["merged"])
    elif name == "device":
        d = dataclasses.replace(d, device=torch.device("meta"))
    else:           # an attribute of the image: mega, size, t_pad, ...
        v = getattr(d, name)
        d = dataclasses.replace(d, **{name: (not v) if isinstance(v, bool)
                                      else v + 1})
    return d, (B, L), st


VARIED = ["sparams", "exhaustive", "tier", "B", "L", "flat_cap",
          "small_ids", "mega", "size", "max_probe", "t_pad", "n_lists",
          "proxi_frac", "merged", "device"]


def test_key_covers_the_jax_statics():
    """Every static argument of the JAX jit but ``pallas_mode`` (no
    counterpart) is varied below."""
    assert _jax_statics() - {"pallas_mode"} <= set(VARIED)


@pytest.mark.parametrize("tier", [0, 1])
@pytest.mark.parametrize("name", VARIED)
def test_key_changes_with_each_static(name, tier, tiny):
    idx = tiny[0]
    sc = _scanner(idx)
    shape, flat_cap = (8, 64), 192
    base = tsd.graph_key(sc.didx, shape, sc._statics(64, tier, flat_cap))
    d, shp, st = _varied(name, idx, sc, shape, tier, flat_cap)
    assert tsd.graph_key(d, shp, st) != base


def test_key_changes_with_nothing_else(tiny):
    """Read contents, a second scanner of the same penalties on the same
    image and a new batch tensor leave the key as it was: those batches
    replay one graph."""
    idx, codes, lengths, _ = tiny
    sc = _scanner(idx)
    other = tsd.DenseScanner(None, Penalties(), batch=8, didx=sc.didx)
    keys = set()
    for s in (sc, other):
        for c in (codes, codes[::-1].copy()):
            ct = torch.from_numpy(c)
            keys.add(tsd.graph_key(s.didx, ct.shape,
                                   s._statics(ct.shape[1], 0, 192)))
    assert len(keys) == 1


# -- (b) output copies under pipelining ---------------------------------------

@pytest.fixture
def graph_daemon(disk_db, tmp_path):
    """A CPU daemon (batch 32) whose image replays stand-in graphs,
    served from a thread on a socket of its own."""
    from kma_tpu_torch.devserve import DevClient, TorchDevServer
    prefix, _ = disk_db
    srv = TorchDevServer(prefix, batch=32, device="cpu")
    assert srv.graphs is None
    srv.didx.graphs = tsd.StepGraphs(capture=stand_in_capture)
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    yield srv, prefix, sock
    DevClient.connect(prefix, sock_path=sock).stop()
    th.join(timeout=30)
    assert not th.is_alive()


def _panel_reads(prefix, n, seed):
    """n 100 bp reads cut from the DB's templates (a third random), padded
    to 128."""
    rng = np.random.default_rng(seed)
    fa = open(os.path.join(os.path.dirname(prefix), "db.fsa")).read()
    seqs = [np.array(["ACGT".index(c) for c in ln], np.uint8)
            for ln in fa.split("\n")[1::2] if ln]
    codes = np.full((n, 128), 4, np.uint8)
    for i in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        o = int(rng.integers(0, len(s) - 100))
        codes[i, :100] = s[o: o + 100] if i % 3 else rng.integers(0, 4, 100)
    return codes, np.full(n, 100, np.int32)


def test_pipelined_requests_replay_as_eager(graph_daemon):
    """Two pipelined dense requests of one key (40 reads: two batches of
    32 rows each), the second dispatched before the first resolves, get
    exactly the eager scanner's replies; the key is captured once and
    replayed for every batch."""
    from kma_tpu_torch.devserve import _recv, _send, _unpack_tid_lists
    srv, prefix, sock = graph_daemon
    pen = Penalties()
    reqs = [_panel_reads(prefix, 40, seed) for seed in (1, 2)]
    meta = {"op": "dense", "M": pen.M, "MM": pen.MM, "U": pen.U,
            "W1": pen.W1, "exhaustive": False, "proxi_frac": None,
            "pipeline": True}
    s = socket.socket(socket.AF_UNIX)
    s.connect(sock)
    for codes, lengths in reqs:
        _send(s, meta, [("codes", codes), ("lengths", lengths)])
    _send(s, {"op": "flush"})
    replies = [_recv(s) for _ in range(3)]
    s.close()
    assert srv.requests["dense_pipelined"] == 2
    eager = tsd.DenseScanner(srv.idx, pen, batch=32, device="cpu")
    assert eager.didx.graphs is None
    for (rm, r), (codes, lengths) in zip(replies, reqs):
        assert rm["ok"] == 1
        exp = eager.scan_reads(codes, lengths)
        assert np.array_equal(r["scores"], exp[0])
        assert np.array_equal(r["modes"], exp[1])
        assert np.array_equal(r["over"].astype(bool), exp[3])
        got = _unpack_tid_lists(r["has"], r["counts"], r["flat"])
        for a, b in zip(got, exp[2]):
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(a, b)
        assert (exp[1] != 0).sum() > 10
    g = srv.graphs
    key0 = [k for k in g.captures if k[10]]       # merged: tier 0
    assert len(key0) == 1 and g.captures[key0[0]] == 1
    assert g.replays[key0[0]] == 4
    assert not srv.faults


def test_native_cli_pipelined_run_matches_device_off(graph_daemon,
                                                     native_cli, tmp_path):
    """The native CLI's -1t1 in slices of 16 reads, three in flight
    (every slice a pipelined dense request), against the stand-in graph
    daemon: byte-identical to -device off."""
    srv, prefix, sock = graph_daemon
    reads = os.path.join(os.path.dirname(prefix), "reads.fq")
    env = dict(os.environ, KMA_DEVSERVE_SOCKET=sock, KMA_DEVSLICE="16",
               KMA_DEVDEPTH="3")
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    r = subprocess.run([native_cli] + args + ["-o", out_dev, "-device",
                                              "on"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "devserve lost" not in r.stderr
    assert srv.requests["dense_pipelined"] >= 4
    assert sum(srv.graphs.replays.values()) >= srv.requests["dense"]
    assert not srv.faults
    r = subprocess.run([native_cli] + args + ["-o", out_host, "-device",
                                              "off"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_dev, out_host)


def test_failed_capture_faults_the_op(graph_daemon):
    """A capture that raises answers the dense request ``ok: 0`` and
    counts a fault; nothing answers it eager."""
    from kma_tpu_torch.devserve import DevClient

    def broken(fn, args, pool=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    srv, prefix, sock = graph_daemon
    srv.didx.graphs = tsd.StepGraphs(capture=broken)
    cli = DevClient.connect(prefix, sock_path=sock)
    codes, lengths = _panel_reads(prefix, 8, 3)
    with pytest.raises(RuntimeError, match="devserve error"):
        cli.dense_scan(codes, lengths, Penalties(), False, None)
    cli.close()
    assert srv.faults == {"dense": 1}
    assert "stream is capturing" in srv.first_fault
    assert not srv.graphs.graphs and not srv.graphs.replays


# -- (c) where the route is taken ---------------------------------------------

def test_cpu_scanner_builds_no_graph(tiny):
    idx, codes, lengths, _ = tiny
    sc = _scanner(idx)
    assert sc.didx.graphs is None
    sc.scan_reads(codes, lengths)
    assert sc.didx.graphs is None


@pytest.mark.parametrize("device,sharded,takes", [
    ("cuda", False, True), ("cuda", True, True), ("cpu", True, False)])
def test_only_an_unsharded_card_image_takes_graphs(device, sharded, takes,
                                                   tiny):
    """The rule of DenseIndex: an image on CUDA cards gets a StepGraphs
    and chain graphs, sharded or not (a sharded one replays its step as
    a ``ShardedStep``); a CPU image none (no CUDA call is made to
    decide)."""
    d = _scanner(tiny[0]).didx
    img = dataclasses.replace(d, device=torch.device(device, 0)
                              if device == "cuda" else d.device,
                              sharded=sharded, graphs=None,
                              chain_graphs=None)
    assert isinstance(img.graphs, tsd.StepGraphs) == takes
    assert isinstance(img.chain_graphs, tsd.StepGraphs) == takes
    if takes:
        assert img.chain_graphs.pools is img.graphs.pools
        assert img.chain_graphs.kernels == ()


def test_launches_count_the_replays():
    """The capture pass records launches and runs none; every replay
    runs the launches its graph holds (the wrapper's count)."""
    def step(codes, lengths, exist, kv, bits):
        sk.run_score_rows.launches += 1      # one kernel launch a call
        return codes + 1, lengths * 2

    g = tsd.StepGraphs(capture=stand_in_capture)
    img = type("Img", (), dict(exist=None, kv=None, bits=None))
    c, n = torch.zeros((4, 8), dtype=torch.uint8), torch.ones(4, dtype=torch.int32)
    n0 = sk.run_score_rows.launches
    out = g.run("k", step, c, n, img)
    assert sk.run_score_rows.launches == n0 + te.WARMUP + 1
    assert torch.equal(out[0], c + 1) and torch.equal(out[1], n * 2)
    out2 = g.run("k", step, c + 2, n, img)
    assert sk.run_score_rows.launches == n0 + te.WARMUP + 2
    assert torch.equal(out2[0], c + 3) and torch.equal(out[0], c + 1)
    assert g.captures["k"] == 1 and g.replays["k"] == 2


def test_least_recently_replayed_graph_goes(monkeypatch):
    monkeypatch.setattr(tsd, "MAX_GRAPHS", 2)
    g = tsd.StepGraphs(capture=stand_in_capture)
    img = type("Img", (), dict(exist=None, kv=None, bits=None))
    c, n = torch.zeros((2, 4), dtype=torch.uint8), torch.ones(2)
    step = lambda c, n, *_: (c + 1, n)           # noqa: E731
    for k in ("a", "b", "a", "c"):
        g.run(k, step, c, n, img)
    assert list(g.graphs) == ["a", "c"]
    assert g.captures == {"a": 1, "b": 1, "c": 1}


# -- (d) the footprint counts the graphs --------------------------------------

def test_footprint_counts_the_graphs(tiny):
    """The footprint's graph term covers MAX_GRAPHS graphs' static inputs
    and outputs at the read pad (measured on stand-in graphs of both
    tiers) and the output copies of IN_FLIGHT requests of REQUEST_READS
    reads; a sharded image's shards count their plans' buffers
    (``plan_bytes``, held in tests/test_torch_graphs_sharded.py)."""
    idx = tiny[0]
    B, L, k = 64, tsd.FOOTPRINT_READ_PAD, idx.kmersize
    sc = tsd.DenseScanner(idx, Penalties(), batch=B, device="cpu")
    sc.didx.graphs = g = tsd.StepGraphs(capture=stand_in_capture)
    rng = np.random.default_rng(0)
    copies = {}
    for tier, rows in ((0, B), (1, tsd.WIDE_ROWS)):
        c = torch.from_numpy(rng.integers(0, 4, (rows, L)).astype(np.uint8))
        n = torch.full((rows,), L, dtype=torch.int32)
        cap = sc.flat_headroom * rows if tier == 0 \
            else 2 * min(tsd.TIERS[1][1], sc.didx.t_pad) * rows
        copies[tier] = sum(t.nbytes for t in sc._call(c, n, tier, cap))
    held = max(sum(t.nbytes for t in (gr.codes, gr.lengths) + gr.out)
               for gr in g.graphs.values())
    need = tsd.MAX_GRAPHS * held + tsd.IN_FLIGHT * -(
        -tsd.REQUEST_READS // B) * copies[0] + copies[1]
    term = tsd.graph_bytes(B, sc.didx.t_pad, L, k)
    assert need <= term < 2 * need
    one = tsd.dense_footprint(100, sc.didx.t_pad, 4096, 1, B, k)[0]
    assert one.graphs == term
    assert one.total == one.bits + one.hash + tsd.IN_FLIGHT * one.workspace \
        + one.ops + term
    two = tsd.dense_footprint(100, 2 * sc.didx.t_pad, 4096, 2, B, k)
    assert tuple(f.graphs for f in two) == tsd.plan_bytes(
        B, 2 * sc.didx.t_pad, 2, L, k)
    assert all(f.graphs > 0 for f in two)
