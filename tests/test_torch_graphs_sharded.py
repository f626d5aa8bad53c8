"""The sharded dense step's graphs (``scan_dense.ShardedStep`` in a
``StepGraphs``) on the CPU, the image sharded over ``["cpu"] * n``.

A CUDA graph exists only on the card, so the cache gets the stand-in
capturer of tests/test_torch_graphs.py: one set of static outputs per
segment, written by every replay from the segment's inputs as they then
hold.  With it the sharded image takes the route a card image takes (its
five segments captured in order, the copies between them), and every
replay must equal the eager sharded step, the unsharded image and, run
through a daemon, the eager replies and ``-device off``'s bytes
(tolerance 0: every output is an integer).  The card's own graphs are
held in tests/test_torch_cuda.py (marked ``cuda``)."""

import dataclasses
import gc
import os
import socket
import subprocess
import threading
import weakref

import numpy as np
import pytest
import torch

from kma_tpu_torch import entry as te
from kma_tpu_torch.mapping import scan_dense as tsd
from kma_tpu_torch.ops import scan_kernel as sk

pytest.importorskip("jax")

from test_torch_devserve import _same_outputs, native_cli  # noqa: E402,F401
from test_torch_devserve_sharded import (_budget, _force_budget,  # noqa: E402,F401,E501
                                         family_db)
from test_torch_graphs import StandInGraph  # noqa: E402
from test_torch_scan_dense_sharded import (_family_db, _pen,  # noqa: E402,F401,E501
                                           _port, _reads, unfused_db)

NS = (2, 3)


class _StandIn(StandInGraph):
    """A stand-in graph whose replays leave the image's ``shard_calls``
    as they were: a graph runs no Python, so the cache adds them."""

    def __init__(self, fn, args, calls):
        self.calls = calls
        super().__init__(fn, args)

    def replay(self):
        saved = list(self.calls)
        super().replay()
        self.calls[:] = saved


def stand_in(didx, log=None):
    """``entry.capture``'s contract on the CPU for the segments of
    ``didx``'s step (WARMUP eager calls, then a capture whose outputs the
    replays overwrite); ``log`` collects the stand-in graphs."""
    def capture(fn, args, pool=None):
        for _ in range(te.WARMUP):
            fn(*args)
        g = _StandIn(fn, args, didx.shard_calls)
        if log is not None:
            log.append(g)
        return g, g.out
    return capture


@pytest.fixture(scope="module")
def db():
    return _family_db(300, 3)


@pytest.fixture(scope="module")
def reads(db):
    return _reads(db[1], 48, 80, 5)


def _graphed(sc, log=None):
    """``sc`` with stand-in graphs on its sharded image."""
    sc.didx.graphs = tsd.StepGraphs(capture=stand_in(sc.didx, log))
    return sc


# -- (a) the key ----------------------------------------------------------------

def test_key_covers_the_layout(db, reads):
    """A sharded image's key holds each shard's device and word range
    where an unsharded one holds its device: the same batch on another
    layout (shard count, a shard's device) is another key."""
    idx, _ = db
    c = torch.from_numpy(reads[0])
    keys = {}
    for n in NS:
        sc = _port(idx, n, batch=len(c))
        d = sc.didx
        st = sc._statics(c.shape[1], 0, 24 * len(c))
        k = tsd.graph_key(d, c.shape, st)
        w = d.shard_bits[0].shape[1]
        assert k.device == tuple(("cpu", s * w, (s + 1) * w)
                                 for s in range(n))
        assert w * n == d.t_pad // 32
        moved = dataclasses.replace(d, devices=d.devices[:-1]
                                    + (torch.device("meta"),))
        assert tsd.graph_key(moved, c.shape, st) != k
        keys[n] = k
    one = tsd.DenseScanner(idx, _pen(), batch=len(c), device="cpu")
    k1 = tsd.graph_key(one.didx, c.shape, one._statics(c.shape[1], 0,
                                                       24 * len(c)))
    assert k1.device == "cpu"
    assert len({keys[2], keys[3], k1}) == 3


# -- (b) a replay is the eager step -------------------------------------------

@pytest.mark.parametrize("proxi", [None, 0.8])
@pytest.mark.parametrize("n", NS)
def test_replay_equals_eager_and_unsharded(db, reads, n, proxi):
    """Tier 0 and tier 1, each key captured once and replayed on other
    batches: meta and flat equal the eager sharded step and the
    unsharded image's bit for bit."""
    idx, _ = db
    codes, lengths = reads
    B = len(codes)
    sc = _graphed(_port(idx, n, batch=B, proxi_frac=proxi))
    one = tsd.DenseScanner(idx, _pen(), batch=B, proxi_frac=proxi,
                           device="cpu")
    d, g = sc.didx, sc.didx.graphs
    batches = [(torch.from_numpy(c), torch.from_numpy(ln)) for c, ln in (
        (codes, lengths), _reads(db[1], B, 80, 6))]
    mapped = 0
    for tier in (0, 1):
        for c, ln in batches:
            st = sc._statics(c.shape[1], tier, 24 * B)
            got = sc._call(c, ln, tier, 24 * B)
            eager = tsd.dense_scan_device(c, ln, d, **st)
            want = one._call(c, ln, tier, 24 * B)
            for x, y, z in zip(got, eager, want):
                assert x.dtype == y.dtype == z.dtype
                assert torch.equal(x, y) and torch.equal(x, z)
            mapped += int(((got[0][:, 1] & 3) != 0).sum())
    assert mapped > B
    assert sorted(k.tier for k in g.graphs) == [0, 1]
    assert all(isinstance(p, tsd._Plan) for p in g.graphs.values())
    assert set(g.captures.values()) == {1} and set(g.replays.values()) == {2}


@pytest.mark.parametrize("proxi", [None, 0.4])
def test_unfused_key_db_replays(unfused_db, proxi):  # noqa: F811
    """The unfused tie key (tier 1 at t_pad 87,040; tier 0's key is
    fused) through the segments, captured and replayed again: equal to
    the unsharded image's step."""
    idx, templates = unfused_db
    B, L = 8, 256
    codes, lengths = _reads(templates, B, 115, 29, err=0.0, ln_cut=1)
    tail, _ = _reads(templates, B, 115, 31, err=0.0, ln_cut=1)
    codes = np.concatenate([codes[:, :115], tail[:, :115],
                            np.full((B, L - 230), 4, np.uint8)], 1)
    lengths[:] = 230
    c_t, l_t = torch.from_numpy(codes), torch.from_numpy(lengths)
    one = tsd.DenseScanner(idx, _pen(), batch=B, proxi_frac=proxi,
                           device="cpu")
    assert not tsd._fused(tsd.ScanParams(*one._sparams(L, 1)),
                          one.didx.t_pad)
    want = one._call(c_t, l_t, 1, 24 * B)
    assert int((want[0][:, 1] >> 3).sum()) >= B
    for n in NS:
        sc = _graphed(_port(idx, n, batch=B, proxi_frac=proxi))
        for _ in range(2):
            got = sc._call(c_t, l_t, 1, 24 * B)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert sum(sc.didx.graphs.replays.values()) == 2


# -- (c) counts, eviction -----------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_shard_calls_count_replays(db, reads, n):
    """A capture counts its warm-up calls on every shard and nothing for
    its capture pass; every replay adds one run-scoring call a shard,
    as the eager step counts (the CPU wrapper counts no launch)."""
    idx, _ = db
    codes, lengths = reads
    B = len(codes)
    sc = _graphed(_port(idx, n, batch=B))
    d = sc.didx
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    n0 = sk.run_score_rows.launches
    for k in range(4):
        sc._call(c, ln, 0, 24 * B)
        assert d.shard_calls == [te.WARMUP + k + 1] * n
    tsd.dense_scan_device(c, ln, d, **sc._statics(c.shape[1], 0, 24 * B))
    assert d.shard_calls == [te.WARMUP + 5] * n
    assert sk.run_score_rows.launches == n0
    # the counts a replay adds: one call on each shard, no launch
    plan = next(iter(d.graphs.graphs.values()))
    assert [sh.g_score[1] for sh in plan.shards] == [(0, 1)] * n


def test_eviction_drops_a_keys_segments_together(db, reads, monkeypatch):
    """MAX_GRAPHS counts keys: past it the least recently replayed key
    goes with all of its segments' graphs."""
    monkeypatch.setattr(tsd, "MAX_GRAPHS", 2)
    idx, _ = db
    codes, lengths = reads
    B = len(codes)
    log = []
    sc = _graphed(_port(idx, 2, batch=B), log)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    g = sc.didx.graphs
    sc._call(c, ln, 0, 24 * B)
    # front, two scores, best, two ties, pack: seven graphs a key
    assert len(log) == 7
    first = [weakref.ref(x) for x in log]
    sc._call(c, ln, 1, 24 * B)
    sc._call(c[:, :64].contiguous(), ln.clamp(max=64), 1, 24 * B)
    assert g.evictions == 1 and len(g.graphs) == 2
    assert {(k.tier, k.L) for k in g.graphs} == {(1, 80), (1, 64)}
    log.clear()
    gc.collect()
    assert all(r() is None for r in first)
    assert sum(g.captures.values()) == 3


# -- (d) the footprint --------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_per_shard_footprint_term(db, n):
    """Each shard's graph term covers its buffers once both tiers are
    captured at the footprint's read pad (measured: the arena's tensors
    by device; the primary's output copies as graph_bytes counts them),
    and stays under twice that."""
    idx, _ = db
    B, L, k = 64, tsd.FOOTPRINT_READ_PAD, idx.kmersize
    sc = _graphed(_port(idx, n, batch=B))
    d = sc.didx
    rng = np.random.default_rng(0)
    copies = {}
    for tier, rows in ((0, B), (1, tsd.WIDE_ROWS)):
        c = torch.from_numpy(rng.integers(0, 4, (rows, L)).astype(np.uint8))
        ln = torch.full((rows,), L, dtype=torch.int32)
        cap = sc.flat_headroom * rows if tier == 0 \
            else 2 * min(tsd.TIERS[1][1], d.t_pad) * rows
        copies[tier] = sum(t.nbytes for t in sc._call(c, ln, tier, cap))
    held = [0] * n
    for (name, _, _), b in d.graphs.arena.bufs.items():
        s = int(name[-1]) if name[-1].isdigit() else 0
        held[s] += b.nbytes
    held[0] += tsd.IN_FLIGHT * -(-tsd.REQUEST_READS // B) * copies[0] \
        + copies[1]
    term = tsd.plan_bytes(B, d.t_pad, n, L, k)
    assert [f.graphs for f in tsd.image_footprint(idx, n, B)] == list(term)
    for need, t in zip(held, term):
        assert need <= t < 2 * need
    # sharding still lowers the primary's total under the one-device one
    assert max(f.total for f in tsd.image_footprint(idx, n, B)) \
        < tsd.image_footprint(idx, 1, B)[0].total


# -- (e) a CPU daemon ---------------------------------------------------------

@pytest.fixture
def sharded_daemon(family_db, tmp_path):  # noqa: F811
    """A sharded CPU daemon (batch 64, two shards) whose image replays
    stand-in graphs, served from a thread on a socket of its own."""
    from kma_tpu_torch import devserve as ds
    prefix, reads = family_db
    with pytest.MonkeyPatch.context() as mp:
        _force_budget(mp, _budget(prefix))
        srv = ds.TorchDevServer(prefix, batch=64, device="cpu",
                                devices=["cpu", "cpu"])
    assert srv.didx.sharded and srv.graphs is None
    srv.didx.graphs = tsd.StepGraphs(capture=stand_in(srv.didx))
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    yield srv, prefix, reads, sock
    ds.DevClient.connect(prefix, sock_path=sock).stop()
    th.join(timeout=30)
    assert not th.is_alive()


def _family_reads(reads, n, skip=0):
    """n reads of the family DB's read file as codes [n, 128], lengths."""
    lines = open(reads).read().split("\n")
    codes = np.full((n, 128), 4, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        s = lines[4 * (skip + i) + 1]
        codes[i, :len(s)] = ["ACGT".index(ch) for ch in s]
        lengths[i] = len(s)
    return codes, lengths


def test_pipelined_requests_replay_as_eager(sharded_daemon):
    """Two pipelined dense requests of 100 reads (two tier-0 batches
    each), the second dispatched before the first resolves: replies equal
    the eager sharded scanner's; the keys are captured once."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.devserve import _recv, _send, _unpack_tid_lists
    srv, prefix, reads, sock = sharded_daemon
    pen = Penalties()
    reqs = [_family_reads(reads, 100, skip) for skip in (0, 150)]
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
    eager = tsd.DenseScanner(None, pen, batch=64, didx=dataclasses.replace(
        srv.didx, graphs=None, shard_calls=[0, 0]))
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
        assert (exp[1] != 0).sum() > 50
    g = srv.didx.graphs
    key0 = [k for k in g.captures if k.tier == 0]
    assert len(key0) == 1 and g.captures[key0[0]] == 1
    assert g.replays[key0[0]] == 4
    assert not srv.faults


def _served_parity(srv, calls0, out_dev, out_host):
    """Every dense batch of the run a replay, calls on every shard, no
    fault; the outputs byte-identical."""
    g = srv.didx.graphs
    assert srv.requests["dense"] > 0
    assert sum(g.replays.values()) >= srv.requests["dense"]
    assert all(c > c0 for c, c0 in zip(srv.didx.shard_calls, calls0))
    assert not srv.faults
    _same_outputs(out_dev, out_host)


def test_native_cli_run_matches_device_off(sharded_daemon,  # noqa: F811
                                           native_cli, tmp_path):
    """The native CLI's -1t1 in slices of 64 reads, three in flight
    (pipelined dense requests), against the sharded stand-in daemon:
    byte-identical to -device off."""
    srv, prefix, reads, sock = sharded_daemon
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    calls0 = list(srv.didx.shard_calls)
    env = dict(os.environ, KMA_DEVSERVE_SOCKET=sock, KMA_DEVSLICE="64",
               KMA_DEVDEPTH="3")
    for out, dev in ((out_dev, "on"), (out_host, "off")):
        r = subprocess.run([native_cli] + args + ["-o", out, "-device",
                                                  dev],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        assert "devserve lost" not in r.stderr
    assert srv.requests["dense_pipelined"] >= 4
    _served_parity(srv, calls0, out_dev, out_host)


def test_python_cli_run_matches_device_off(sharded_daemon, tmp_path,
                                           capfd, monkeypatch):
    """The Python CLI's -1t1 against the sharded stand-in daemon:
    byte-identical to -device off."""
    from kma_tpu.cli.main import main
    srv, prefix, reads, sock = sharded_daemon
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    calls0 = list(srv.didx.shard_calls)
    monkeypatch.setenv("KMA_DEVSERVE_SOCKET", sock)
    assert main(args + ["-o", out_dev, "-device", "on"]) in (0, None)
    err = capfd.readouterr().err
    assert "# device: using devserve session" in err
    assert "devserve lost" not in err
    assert main(args + ["-o", out_host, "-device", "off"]) in (0, None)
    _served_parity(srv, calls0, out_dev, out_host)


def test_failed_capture_faults_the_op(sharded_daemon):
    """A segment whose capture raises answers the dense request ``ok: 0``
    and counts a fault; nothing answers it eager and no key is kept."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.devserve import DevClient
    srv, prefix, reads, sock = sharded_daemon
    capture, seen = stand_in(srv.didx), []

    def broken(fn, args, pool=None):
        seen.append(fn)
        if len(seen) == 3:       # shard 1's score segment
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return capture(fn, args, pool)

    srv.didx.graphs = tsd.StepGraphs(capture=broken)
    cli = DevClient.connect(prefix, sock_path=sock)
    codes, lengths = _family_reads(reads, 8)
    with pytest.raises(RuntimeError, match="devserve error"):
        cli.dense_scan(codes, lengths, Penalties(), False, None)
    cli.close()
    assert srv.faults == {"dense": 1}
    assert "stream is capturing" in srv.first_fault
    assert not srv.graphs.graphs and not srv.graphs.replays
