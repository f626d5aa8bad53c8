"""The pair-stream step's graph cache (``scan_fast.fast_key`` and
``device_index.step_graphs``, a ``scan_dense.StepGraphs``) on the CPU.

As in tests/test_torch_graphs.py, a stand-in capturer behaves as a CUDA
graph does for the cache (one set of static outputs, rewritten by every
replay), so a CPU pair-stream daemon (the fixture of
tests/test_torch_devserve_pair_stream.py) takes the cache's route at
tier 0 and at the wide tier.  Its replies must equal the eager
scanner's, the JAX ``FastScanner``'s and a native ``-1t1`` run's
``-device off`` bytes (tolerance 0: every output is an integer).  The
card's own graphs are held in tests/test_torch_cuda.py (marked
``cuda``)."""

import dataclasses
import os
import re
import socket
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kma_tpu_torch import entry as te
from kma_tpu_torch.config import Penalties
from kma_tpu_torch.mapping import scan_dense as tsd
from kma_tpu_torch.mapping import scan_fast as tsf
from kma_tpu_torch.mapping.device_index import DeviceIndex, step_graphs
from kma_tpu_torch.mapping.scan_common import WIDE_ROWS
from kma_tpu_torch.ops import scan_kernel as sk

pytest.importorskip("jax")

from test_torch_devserve import _same_outputs, disk_db, native_cli  # noqa: E402,F401,E501
from test_torch_devserve_pair_stream import _jax_expect, _reads, _same, daemon  # noqa: E402,F401,E501
from test_torch_graphs import stand_in_capture  # noqa: E402
from kma_tpu.devserve import socket_path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
#: the read pad of the requests below: chimeric reads of up to 1,008 bp
WIDE_L = 1024


@pytest.fixture(scope="module")
def tiny():
    return te.tiny_problem()[0]


def _scanner(idx, **kw):
    return tsf.FastScanner(idx, kw.pop("pen", Penalties()), batch=8,
                           device="cpu", **kw)


# -- (a) the key --------------------------------------------------------------

def _jax_statics():
    """The static_argnames of the JAX jit of fast_scan_device, read from
    its source."""
    src = (REPO / "kma_tpu" / "mapping" / "scan_fast.py").read_text()
    m = re.search(r"static_argnames=\(([^)]*)\)\)\s*\ndef fast_scan_device",
                  src)
    return set(re.findall(r'"(\w+)"', m.group(1)))


def _varied(name, idx, sc, shape, tier, flat_cap):
    """(image, shape, statics) of a batch of ``shape`` at ``tier`` on
    ``sc`` with the static argument ``name`` (or B, L, the device)
    changed."""
    d, (B, L) = sc.didx, shape
    st = sc._statics(tier, flat_cap)
    if name == "sparams":
        # the penalty set is in it, with the tier's caps and small_ids
        st = dict(st, sparams=_scanner(
            idx, pen=dataclasses.replace(Penalties(), MM=-3)
        )._statics(tier, flat_cap)["sparams"])
    elif name == "exhaustive":
        st = dict(st, sparams=_scanner(idx, exhaustive=True)._statics(
            tier, flat_cap)["sparams"])
    elif name == "small_ids":
        p = tsf.ScanParams(*st["sparams"])
        st = dict(st, sparams=tuple(dataclasses.astuple(
            dataclasses.replace(p, small_ids=not p.small_ids))))
    elif name == "tier":
        st = sc._statics(1 - tier, flat_cap)
    elif name == "B":
        B += 8
    elif name == "L":
        L += 64
    elif name == "flat_cap":
        st = dict(st, flat_cap=flat_cap + 8)
    elif name == "proxi_frac":
        st = _scanner(idx, proxi_frac=0.9)._statics(tier, flat_cap)
    elif name == "device":
        d = dataclasses.replace(d, device=torch.device("meta"))
    else:           # an attribute of the image: mega, size, max_probe, ...
        v = getattr(d, name)
        d = dataclasses.replace(d, **{name: (not v) if isinstance(v, bool)
                                      else v + 1})
    return d, (B, L), st


VARIED = ["sparams", "exhaustive", "small_ids", "tier", "B", "L",
          "flat_cap", "mega", "size", "max_probe", "null_index",
          "proxi_frac", "device"]


def test_key_covers_the_jax_statics():
    """Every static argument of the JAX jit of fast_scan_device is varied
    below."""
    statics = _jax_statics()
    assert "sparams" in statics and "null_index" in statics
    assert statics <= set(VARIED)


@pytest.mark.parametrize("tier", [0, 1])
@pytest.mark.parametrize("name", VARIED)
def test_key_changes_with_each_static(name, tier, tiny):
    sc = _scanner(tiny)
    shape, flat_cap = (8, 64), 64
    base = tsf.fast_key(sc.didx, shape, sc._statics(tier, flat_cap))
    assert base.tier == tier
    d, shp, st = _varied(name, tiny, sc, shape, tier, flat_cap)
    assert tsf.fast_key(d, shp, st) != base


def test_key_changes_with_nothing_else(tiny):
    """Read contents, a second scanner of the same penalties on the same
    image, a new batch tensor and the image's own tensors leave the key
    as it was: those batches replay one graph."""
    codes = te.tiny_problem()[1]
    sc = _scanner(tiny)
    other = tsf.FastScanner(None, Penalties(), batch=8, didx=sc.didx)
    copy = dataclasses.replace(sc.didx, values=sc.didx.values.clone(),
                               exist=sc.didx.exist.clone())
    keys = set()
    for s in (sc, other):
        for d in (s.didx, copy):
            for c in (codes, codes[::-1].copy()):
                ct = torch.from_numpy(c)
                keys.add(tsf.fast_key(d, ct.shape, s._statics(0, 64)))
    assert len(keys) == 1


# -- (b) the daemon's route, pipelined ----------------------------------------

@pytest.fixture
def graph_ps(daemon):
    """The pair-stream daemon with stand-in graphs on its image (a fresh
    cache each test; taken away after, with any fault it counted)."""
    srv, prefix, _ = daemon
    assert srv.scanner_kind == "pair_stream" and srv.graphs is None
    srv.didx.graphs = step_graphs(capture=stand_in_capture)
    try:
        yield srv, prefix
    finally:
        srv.didx.graphs = None
        srv.faults.clear()
        srv.first_fault = None


def _templates(prefix):
    fa = open(os.path.join(os.path.dirname(prefix), "db.fsa")).read()
    return np.array([["ACGT".index(c) for c in ln]
                     for ln in fa.split("\n")[1::2] if ln], np.uint8)


def _chimeras(prefix, n, seed):
    """n reads of 56-63 segments of 16 bp, each segment alternately a
    k-mer only one template holds and one every template holds: every
    segment starts a run, so each read passes tier 0's 48 runs and goes
    through the wide tier (up to 1,008 bp)."""
    S = _templates(prefix)
    T, n_bp = S.shape
    uniq = [(t, p) for p in range(16, n_bp - 16) for t in range(T)
            if (S[:, p] != S[t, p]).sum() == T - 1]
    cons = [p for p in range(0, n_bp - 16, 16)
            if (S[:, p: p + 16] == S[0, p: p + 16]).all()]
    assert len(uniq) > 8 and len(cons) > 8
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = []
        for j in range(56 + i % 8):
            if j % 2:
                p = cons[int(rng.integers(len(cons)))]
                parts.append(S[0, p: p + 16])
            else:
                t, p = uniq[int(rng.integers(len(uniq)))]
                o = p - int(rng.integers(0, 16))
                parts.append(S[t, o: o + 16])
        out.append(np.concatenate(parts))
    return out


def _request(prefix, seed):
    """24 of the pair-stream tests' 100 bp reads and 8 chimeras, shuffled,
    padded to WIDE_L."""
    short, _ = _reads(prefix, 24, seed)
    seqs = [r[:100] for r in short] + _chimeras(prefix, 8, seed)
    order = np.random.default_rng(seed).permutation(len(seqs))
    codes = np.full((len(seqs), WIDE_L), 4, np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, j in enumerate(order):
        codes[i, :len(seqs[j])] = seqs[j]
        lengths[i] = len(seqs[j])
    return codes, lengths


def test_pipelined_requests_replay_as_eager(graph_ps):
    """Two pipelined dense requests of 32 reads (one tier-0 batch and one
    wide chunk each), the second dispatched before the first resolves:
    each reply equals the eager scanner's and the JAX FastScanner's; the
    tier-0 key and the wide key are each captured once and replayed for
    every batch."""
    from kma_tpu_torch.devserve import _recv, _send, _unpack_tid_lists
    srv, prefix = graph_ps
    pen = Penalties()
    reqs = [_request(prefix, seed) for seed in (5, 6)]
    meta = {"op": "dense", "M": pen.M, "MM": pen.MM, "U": pen.U,
            "W1": pen.W1, "exhaustive": False, "proxi_frac": None,
            "pipeline": True}
    n0 = srv.requests["dense_pipelined"]
    sc = srv._scanner(meta)
    w0 = sc.wide_reads
    s = socket.socket(socket.AF_UNIX)
    s.connect(socket_path(prefix))
    s.settimeout(120)
    for codes, lengths in reqs:
        _send(s, meta, [("codes", codes), ("lengths", lengths)])
    _send(s, {"op": "flush"})
    replies = [_recv(s) for _ in range(3)]
    s.close()
    assert srv.requests["dense_pipelined"] == n0 + 2
    assert sc.wide_reads - w0 >= 16
    eager = tsf.FastScanner(srv.idx, pen, batch=32, device="cpu")
    assert eager.didx.graphs is None
    for (rm, r), (codes, lengths) in zip(replies, reqs):
        assert rm["ok"] == 1, rm
        got = (r["scores"], r["modes"],
               _unpack_tid_lists(r["has"], r["counts"], r["flat"]),
               r["over"])
        exp = eager.scan_reads(codes, lengths).lists()
        _same(got, exp)
        _same(got, _jax_expect(prefix, codes, lengths, pen))
        assert (exp[1] != 0).sum() > 16
    assert eager.wide_reads >= 16
    g = srv.graphs
    by_tier = {k.tier: k for k in g.graphs}
    assert sorted(by_tier) == [0, 1]
    assert all(g.captures[k] == 1 and g.replays[k] == 2
               for k in by_tier.values())
    assert (by_tier[0].B, by_tier[1].B) == (32, WIDE_ROWS)
    assert all(k.L == WIDE_L for k in g.graphs)
    assert all(gr.launches == () for gr in g.graphs.values())
    assert not srv.faults


def test_native_cli_wide_reads_match_device_off(graph_ps, disk_db,  # noqa: F811,E501
                                                native_cli, tmp_path):
    """The native CLI's -1t1 on the DB's reads and 16 chimeras served by
    the stand-in graph daemon (tier 0 and wide tier replayed):
    byte-identical to -device off."""
    srv, prefix = graph_ps
    _, reads = disk_db
    fq = tmp_path / "wide.fq"
    with open(fq, "w") as f:
        f.write(open(reads).read())
        for i, c in enumerate(_chimeras(prefix, 16, 7)):
            s = "".join("ACGT"[x] for x in c)
            f.write("@w%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    w0 = sum(sc.wide_reads for sc in srv.scanners.values())
    p0 = srv.requests["dense_pipelined"]
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    args = ["-i", str(fq), "-t_db", prefix, "-1t1"]
    r = subprocess.run([native_cli] + args + ["-o", out_dev, "-device",
                                              "on"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "devserve lost" not in r.stderr
    assert srv.requests["dense_pipelined"] > p0
    assert sum(sc.wide_reads for sc in srv.scanners.values()) - w0 >= 16
    g = srv.graphs
    assert {k.tier for k, n in g.replays.items() if n} == {0, 1}
    assert sum(g.replays.values()) >= srv.requests["dense_pipelined"] - p0
    assert not srv.faults
    r = subprocess.run([native_cli] + args + ["-o", out_host, "-device",
                                              "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_dev, out_host)


def test_failed_capture_faults_the_op(graph_ps):
    """A capture that raises answers the dense request ``ok: 0`` and
    counts a fault; nothing answers it eager and no graph is kept."""
    from kma_tpu_torch.devserve import DevClient

    def broken(fn, args, pool=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    srv, prefix = graph_ps
    srv.didx.graphs = step_graphs(capture=broken)
    cli = DevClient.connect(prefix, sock_path=socket_path(prefix))
    codes, lengths = _reads(prefix, 8)
    with pytest.raises(RuntimeError, match="devserve error"):
        cli.dense_scan(codes, lengths, Penalties(), False, None)
    cli.close()
    assert srv.faults == {"dense": 1}
    assert "stream is capturing" in srv.first_fault
    assert not srv.graphs.graphs and not srv.graphs.replays


# -- (c) where the route is taken ---------------------------------------------

def test_cpu_image_builds_no_graph(tiny):
    d = DeviceIndex.from_host(tiny, "cpu")
    assert d.graphs is None
    sc = tsf.FastScanner(None, Penalties(), batch=8, didx=d)
    codes, lengths = te.tiny_problem()[1:3]
    sc.scan_reads(codes, lengths)
    assert d.graphs is None


def test_a_card_image_takes_pair_stream_graphs(tiny):
    """The rule of DeviceIndex: an image on a CUDA card gets the
    pair-stream step's cache (its exist, kv and values; no kernel to
    count), without a CUDA call to decide."""
    d = DeviceIndex.from_host(tiny, "cpu")
    img = dataclasses.replace(d, device=torch.device("cuda", 0))
    assert isinstance(img.graphs, tsd.StepGraphs)
    assert img.graphs.tensors == ("exist", "kv", "values")
    assert img.graphs.kernels == ()


# -- (d) the dense route as it was --------------------------------------------

def test_dense_cache_keeps_its_tensors_kernel_and_keys(tiny):
    """The dense image's cache reads exist, kv and bits and counts
    run_score_rows; its key is the tuple it was (the JAX statics, L and
    the device, in that order)."""
    g = tsd.StepGraphs()
    assert g.tensors == ("exist", "kv", "bits")
    assert g.kernels == (sk.run_score_rows,)
    sc = tsd.DenseScanner(te.tiny_problem()[0], Penalties(), batch=8,
                          device="cpu")
    d, st = sc.didx, sc._statics(64, 0, 192)
    key = tsd.graph_key(d, (8, 64), st)
    assert key == (st["sparams"], 8, 192, st["small_ids"], d.mega, d.size,
                   d.max_probe, d.t_pad, d.n_lists, None, True, 64, "cpu")
    assert (key.tier, key.B, key.L) == (0, 8, 64)


def test_pair_stream_cache_counts_no_launch():
    """A step that launches no hand-written kernel: the capture and the
    replays leave every wrapper's count as the step left it, and its
    graph holds no launch."""
    def step(codes, lengths, exist, kv, values):
        return codes + 1, values[:2] * 2

    img = type("Img", (), dict(exist=None, kv=None,
                               values=torch.arange(4)))
    g = step_graphs(capture=stand_in_capture)
    n0 = sk.run_score_rows.launches
    c = torch.zeros((2, 4), dtype=torch.uint8)
    for i in range(3):
        out = g.run("k", step, c + i, c[:, 0], img)
        assert torch.equal(out[0], c + i + 1)
    assert sk.run_score_rows.launches == n0
    assert g.graphs["k"].launches == ()
    assert g.captures["k"] == 1 and g.replays["k"] == 3
