"""The chain op's graphs (``chain_device.chain_graphs``, a
``scan_dense.StepGraphs`` keyed by ``chain_key``) on the CPU.

A CUDA graph exists only on the card, so the image gets the stand-in
capturer of tests/test_torch_graphs.py.  A replayed lookup must equal
the eager ``chain_lookup`` and the JAX ``_chain_lookup`` (tolerance 0:
list ids), a run's short last request must replay the key of the
requests before it, and a CPU daemon with stand-in chain graphs must
serve the Python CLI's unfused default mode at byte parity with
``-device off``.  A stopped daemon must leave nothing of its image
alive.  The card's own chain graphs are held in tests/test_torch_cuda.py
(marked ``cuda``)."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kma_tpu.mapping import chain_device as jcd  # noqa: E402
from kma_tpu.mapping import scan_dense as jsd  # noqa: E402
from kma_tpu_torch.mapping import chain_device as tcd  # noqa: E402
from kma_tpu_torch.mapping import scan_dense as tsd  # noqa: E402

from test_dense_scan import tiny_db  # noqa: E402,F401
from test_torch_chain_device import _reads  # noqa: E402
from test_torch_dense_index import mega_db  # noqa: E402,F401
from test_torch_devserve import _same_outputs, disk_db  # noqa: E402,F401
from test_torch_graphs import stand_in_capture  # noqa: E402


def _graphed(idx):
    """A CPU image whose chain op replays stand-in graphs."""
    d = tsd.DenseIndex.from_host(idx, "cpu")
    assert d.chain_graphs is None
    d.chain_graphs = tcd.chain_graphs(capture=stand_in_capture)
    return d


@pytest.mark.parametrize("L", [128, 600])
@pytest.mark.parametrize("db", ["tiny_db", "mega_db"])
def test_replay_equals_eager_and_jax(db, L, request):
    """Two requests of one key (the second of other reads), replayed: the
    rows of both strands equal the eager lookup and the JAX jit's."""
    idx, templates = request.getfixturevalue(db)
    t = _graphed(idx)
    j = jsd.DenseIndex.from_host(idx)
    g = t.chain_graphs
    for seed in (L, L + 1):
        codes, lengths = _reads(templates, L, seed=seed)
        got = tcd.chain_lookup_dense(t, idx, codes, lengths)
        eager = tcd.chain_lookup(t, torch.from_numpy(codes),
                                 torch.from_numpy(lengths))
        want = jcd._chain_lookup(j.exist, j.kv, codes, lengths,
                                 k=idx.kmersize, mega=j.mega, size=j.size,
                                 max_probe=j.max_probe)
        for a, b, c in zip(got, eager, want):
            assert a.dtype == np.int32 and a.shape == (len(codes),
                                                       L - idx.kmersize + 1)
            assert np.array_equal(a, b.numpy())
            assert np.array_equal(a, np.asarray(c))
        assert (got[0] >= 0).sum() > 0 and (got[1] >= 0).sum() > 0
    key = tcd.chain_key(t, tcd.CHAIN_ROWS[0], L)
    assert list(g.graphs) == [key] and g.captures[key] == 1
    assert g.replays[key] == 2 and g.kernels == ()


def test_key_is_the_jax_statics_rows_and_pad(tiny_db):  # noqa: F811
    """The key holds k, mega, size and max_probe (the JAX jit's statics),
    the padded rows, L and the device."""
    idx, _ = tiny_db
    d = tsd.DenseIndex.from_host(idx, "cpu")
    assert tcd.chain_key(d, 2048, 128) == (
        "chain", d.kmersize, d.mega, d.size, d.max_probe, 2048, 128, "cpu")
    assert len({tcd.chain_key(d, r, L) for r in (2048, 16384)
                for L in (128, 192)}) == 4


def test_rows_classes():
    """A chunk's rows go up to the clients' request rows that hold it, or
    to a full chunk (CHAIN_WINDOWS windows) past them or at long L."""
    full = tsd.CHAIN_WINDOWS // (128 - 16 + 1)
    assert [tcd.chain_rows(n, 128, 16) for n in (1, 700, 2048, 2049,
                                                 16384, 16385, full)] \
        == [2048, 2048, 2048, 16384, 16384, full, full]
    L = 30000
    assert tcd.chain_rows(100, L, 16) == tsd.CHAIN_WINDOWS // (L - 15)


def test_short_tail_reuses_its_key(tiny_db, monkeypatch):  # noqa: F811
    """Rows classes of 16 and 64 (the clients' 2,048 and 16,384 scaled
    down): requests of 16 rows and their 7-row tail replay one key,
    requests of 64 and tails of 20 and 10 the two keys; a request past a
    chunk (CHAIN_WINDOWS of 3 rows) goes in chunks whose last is padded
    to the same rows.  Every reply equals the eager lookup."""
    idx, templates = tiny_db
    L = 128
    W = L - idx.kmersize + 1
    monkeypatch.setattr(tcd, "CHAIN_ROWS", (16, 64))
    t = _graphed(idx)
    g = t.chain_graphs
    codes, lengths = _reads(templates, L, seed=7, B=64)
    for n in (16, 16, 7, 64, 64, 20, 10):
        got = tcd.chain_lookup_dense(t, idx, codes[:n], lengths[:n])
        eager = tcd.chain_lookup(t, torch.from_numpy(codes[:n]),
                                 torch.from_numpy(lengths[:n]))
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(got, eager))
    assert {k[5] for k in g.graphs} == {16, 64}
    assert sum(g.captures.values()) == 2 and sum(g.replays.values()) == 7
    monkeypatch.setattr(tcd, "CHAIN_WINDOWS", 3 * W)
    got = tcd.chain_lookup_dense(t, idx, codes[:10], lengths[:10])
    eager = tcd.chain_lookup(t, torch.from_numpy(codes[:10]),
                             torch.from_numpy(lengths[:10]))
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(got, eager))
    key3 = tcd.chain_key(t, 3, L)
    assert g.captures[key3] == 1 and g.replays[key3] == 4


def test_chain_graphs_hold_at_most_their_cap(tiny_db, monkeypatch):  # noqa: F811,E501
    """The chain cache holds CHAIN_GRAPHS keys, the least recently
    replayed going first."""
    idx, templates = tiny_db
    t = _graphed(idx)
    g = t.chain_graphs
    assert g.max_graphs == tsd.CHAIN_GRAPHS
    for L in (128, 192, 256, 320, 128, 384):
        codes, lengths = _reads(templates, L, seed=L, B=4)
        tcd.chain_lookup_dense(t, idx, codes, lengths)
    assert [k[6] for k in g.graphs] == [256, 320, 128, 384]
    assert g.evictions == 1


# -- a CPU daemon ---------------------------------------------------------------

@pytest.fixture
def chain_daemon(disk_db, tmp_path):  # noqa: F811
    """A CPU daemon (batch 32) whose image replays stand-in graphs of both
    ops, served from a thread on a socket of its own."""
    from kma_tpu_torch.devserve import DevClient, TorchDevServer
    prefix, reads = disk_db
    srv = TorchDevServer(prefix, batch=32, device="cpu")
    assert srv.chain_graphs is None
    srv.didx.graphs = tsd.StepGraphs(capture=stand_in_capture)
    srv.didx.chain_graphs = tcd.chain_graphs(capture=stand_in_capture)
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    yield srv, prefix, reads, sock, th
    cli = DevClient.connect(prefix, sock_path=sock)
    if cli is not None:
        cli.stop()
    th.join(timeout=30)
    assert not th.is_alive()


def test_python_default_mode_replays_chain_graphs(chain_daemon, tmp_path,
                                                  capfd, monkeypatch):
    """The Python CLI's unfused default mode (``KMA_TPU_NO_FUSED=1``,
    DeviceChainStream) against the daemon: every chain request replayed
    from a graph, the output byte-identical to -device off."""
    from kma_tpu.cli.main import main
    srv, prefix, reads, sock, _ = chain_daemon
    monkeypatch.setenv("KMA_TPU_NO_FUSED", "1")
    monkeypatch.setenv("KMA_DEVSERVE_SOCKET", sock)
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    assert main(["-i", reads, "-t_db", prefix, "-o", out_dev, "-device",
                 "on"]) in (0, None)
    err = capfd.readouterr().err
    assert "# device: using devserve session" in err
    assert "devserve lost" not in err
    g = srv.chain_graphs
    assert srv.requests["chain"] > 0
    assert sum(g.replays.values()) >= srv.requests["chain"]
    assert all(k[5] == tcd.CHAIN_ROWS[0] for k in g.graphs)
    assert not srv.faults
    assert main(["-i", reads, "-t_db", prefix, "-o", out_host, "-device",
                 "off"]) in (0, None)
    _same_outputs(out_dev, out_host)


def test_stopped_daemon_frees_its_image(disk_db, tmp_path):  # noqa: F811
    """After a daemon served both ops from its graphs, stopped, and was
    let go, nothing holds its image, its graphs or its scanners (the
    card's memory of a torn-down daemon comes back)."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.devserve import DevClient, TorchDevServer
    prefix, _ = disk_db
    srv = TorchDevServer(prefix, batch=32, device="cpu")
    srv.didx.graphs = tsd.StepGraphs(capture=stand_in_capture)
    srv.didx.chain_graphs = tcd.chain_graphs(capture=stand_in_capture)
    srv.warm([128], verbose=False)
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    cli = DevClient.connect(prefix, sock_path=sock)
    codes = np.full((40, 128), 4, np.uint8)
    codes[:, :100] = np.random.default_rng(3).integers(0, 4, (40, 100))
    lengths = np.full(40, 100, np.int32)
    cli.dense_scan(codes, lengths, Penalties(), False, None)
    cli.chain_lookup(codes, lengths)
    cli.stop()
    cli.close()
    th.join(timeout=30)
    assert not th.is_alive()
    assert sum(srv.graphs.replays.values()) > 0
    assert sum(srv.chain_graphs.replays.values()) > 0
    refs = [weakref.ref(x) for x in (srv, srv.didx, srv.graphs,
                                     srv.chain_graphs,
                                     *srv.scanners.values())]
    del srv, th
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)
