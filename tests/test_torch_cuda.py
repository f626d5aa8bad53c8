"""kma_tpu_torch's CUDA kernels against their plain versions on the card.

Marked ``cuda``: these skip without a CUDA card (a CUDA kernel has no
CPU mode).  On a machine with one, run
``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


def _runs(seed, G, R, V, T, dev, sparse=False):
    """Run arrays and a membership table: dense random bits, or sparse
    rows as a panel has them (a list holds a family of 1-5 templates);
    n_runs spans 0 to past R."""
    rng = np.random.default_rng(seed)
    W32 = T // 32
    if sparse:
        bits = np.zeros((V, T), bool)
        for v in range(V):
            t0 = int(rng.integers(0, T - 5))
            bits[v, t0 + rng.choice(5, int(rng.integers(1, 6)),
                                    replace=False)] = True
        bits = np.packbits(bits.reshape(V, W32, 32), axis=-1,
                           bitorder="little")
        bits = np.ascontiguousarray(bits).view("<i4").reshape(V, W32)
    else:
        bits = rng.integers(-(1 << 31), 1 << 31, (V, W32)).astype(np.int32)
    n_runs = rng.integers(0, R + 3, G).astype(np.int32)
    n_runs[:3] = 0
    lens = rng.integers(0, 20, (G, R))
    start = np.cumsum(rng.integers(1, 40, (G, R)) + lens, axis=1)
    arrays = dict(
        tab=bits, run_row=rng.integers(0, V, (G, R)).astype(np.int32),
        rstart=start.astype(np.int32),
        rend=(start + lens).astype(np.int32),
        rscore=rng.integers(-20, 60, (G, R)).astype(np.int32),
        n_runs=n_runs, rc=rng.integers(0, 2, G).astype(np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@pytest.mark.parametrize("mlen,R,T,sparse", [
    (16, 48, 2304, False), (12, 48, 2304, True), (16, 192, 2304, True),
    (16, 256, 160, False), (16, 48, 4096 + 96, True),
    (16, 192, 8192 + 32, False)])
def test_run_score_entries_match_plain(cuda, mlen, R, T, sparse):
    """Both entries equal their plain versions: panel-like sparse rows
    and dense random bits, rows with no runs, R up to 256, and T past
    one block's tile of 4,096 templates and not a multiple of it."""
    from kma_tpu_torch.mapping.scan_common import ScanParams
    from kma_tpu_torch.ops import scan_kernel as sk
    a = _runs(mlen + R + T, 256, R, 300, T, cuda, sparse)
    p = ScanParams(k=16, mlen=mlen, M=1, MM=-2, U=-1, W1=-3, max_list=9,
                   exhaustive=False, max_probe=0, run_cap=R)
    rest = (a["rstart"], a["rend"], a["rscore"], a["n_runs"], a["rc"])
    n0 = sk.run_score_rows.launches
    got = sk.run_score_rows(a["tab"], a["run_row"], *rest, p=p)
    exp = sk.run_score_rows_plain(a["tab"], a["run_row"], *rest, p=p)
    assert sk.run_score_rows.launches == n0 + 1
    memb = a["tab"][a["run_row"].long()].contiguous()
    got2 = sk.run_score_gathered(memb, *rest, p=p)
    for x, y in zip(got + got2, exp + exp):
        assert torch.equal(x, y)
    assert (exp[1] < sk.BIG).any() and (exp[1] == sk.BIG).any()


def test_run_score_refuses_r_past_256(cuda):
    from kma_tpu_torch.mapping.scan_common import ScanParams
    from kma_tpu_torch.ops import scan_kernel as sk
    a = _runs(1, 8, 257, 20, 256, cuda)
    p = ScanParams(k=16, mlen=16, M=1, MM=-2, U=-1, W1=-3, max_list=9,
                   exhaustive=False, max_probe=0, run_cap=257)
    with pytest.raises(RuntimeError):
        sk.run_score_rows(a["tab"], a["run_row"], a["rstart"], a["rend"],
                          a["rscore"], a["n_runs"], a["rc"], p=p)


def _nw_cases(rng, B, L):
    """Every k mode; half-bands up to what L holds, a third of them wider
    than t_len; t_len 1 among them."""
    ts, qs, tl, ql, kf, hbs = [], [], [], [], [], []
    for b in range(B):
        hb = int(rng.integers(1, (L - 2) // 2 + 1))
        tlen = 1 if b % 7 == 3 else int(
            rng.integers(1, 2 * hb + 2) if b % 3 == 0
            else rng.integers(2 * hb + 1, 2 * hb + 200))
        qlen = max(1, tlen + int(rng.integers(-hb, hb + 1)))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = np.resize(t, qlen).astype(np.uint8)
        pos = rng.integers(0, qlen, qlen // 10 + 1)
        q[pos] = rng.integers(0, 5, len(pos))
        ts.append(t)
        qs.append(q)
        tl.append(tlen)
        ql.append(qlen)
        kf.append([0, 1, -1, 2, -2][b % 5])
        hbs.append(hb)
    return ts, qs, tl, ql, np.asarray(kf, np.int32), np.asarray(hbs)


@pytest.mark.parametrize("L", [32, 64, 256, 1024])
def test_nw_entries_match_plain(cuda, L):
    """The slab, codes and qext entries equal their plain versions at
    every L the callers may send, in every k mode, with half-bands wider
    than t_len and t_len 1; qext equals the slab entry on expand_qext's
    slab and counts as a codes-fed launch."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.ops import nw_kernel as nk
    pen = Penalties()
    d = pen.score_matrix()[:5, :5]
    kw = dict(W1=pen.W1, U=pen.U, MM=pen.MM)
    rng = np.random.default_rng(L)
    ts, qs, tl, ql, kfa, hbs = _nw_cases(rng, 101, L)
    tl_, ql_, hb, qc0, tcol, inj = nk.stage_code_inputs(ts, qs, tl, ql,
                                                        2 * hbs)
    # stage_code_inputs pads L to 128; cut or pad the rows to this L
    qc0 = np.pad(qc0, ((0, 0), (0, max(0, L - qc0.shape[1]))),
                 constant_values=5)[:, :L]
    R = tcol.shape[0]
    qext = np.ascontiguousarray(np.concatenate([inj.T[:, ::-1], qc0], 1))
    C = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (tl_, ql_, kfa, hb, qc0, tcol, inj, qext)]
    got = nk.nw_band_score_codes(*C[:7], dmat=d, **kw)
    assert torch.equal(got, nk.nw_band_score_codes_plain(*C[:7], dmat=d,
                                                         **kw))
    n0 = nk.nw_band_score_codes.launches
    qx = nk.nw_band_score_qext(*C[:4], C[7], C[5], dmat=d, **kw)
    assert nk.nw_band_score_codes.launches == n0 + 1
    assert torch.equal(qx, got)
    msc = nk.expand_qext(C[7], C[5], d)
    assert tuple(msc.shape) == (R, len(ts), L)
    slab = nk.nw_band_score(C[0], C[1], C[2], msc, C[3], **kw)
    assert torch.equal(slab, nk.nw_band_score_plain(C[0], C[1], C[2], msc,
                                                    C[3], **kw))
    assert torch.equal(slab, qx)


def test_nw_kernel_matches_plain_and_oracle(cuda):
    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    from kma_tpu_torch.ops import nw_kernel as nk
    pen = Penalties()
    d = pen.score_matrix()
    rng = np.random.default_rng(5)
    ts, qs, tl, ql, kf, bands = [], [], [], [], [], []
    for b in range(80):
        band = [16, 32, 64, 128][b % 4]
        tlen = int(rng.integers(band, 260))
        qlen = max(1, tlen + int(rng.integers(-band // 2, band // 2 + 1)))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = np.resize(t, qlen).astype(np.uint8)
        pos = rng.integers(0, qlen, qlen // 10)
        q[pos] = rng.integers(0, 5, len(pos))
        ts.append(t)
        qs.append(q)
        tl.append(tlen)
        ql.append(qlen)
        kf.append([0, 1, -1, 2, -2][b % 5])
        bands.append(band)
    tl_, ql_, hb, qext, tcol = nk.stage_qext(ts, qs, tl, ql, bands)
    Q = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (tl_, ql_, np.asarray(kf, np.int32), hb, qext, tcol)]
    msc = nk.expand_qext(Q[4], Q[5], d[:5, :5])
    got = nk.nw_band_score(Q[0], Q[1], Q[2], msc, Q[3], pen.W1, pen.U,
                           pen.MM)
    plain = nk.nw_band_score_plain(Q[0], Q[1], Q[2], msc, Q[3], pen.W1,
                                   pen.U, pen.MM)
    assert torch.equal(got, plain)
    exp = [nw_band(ts[b], qs[b], kf[b], 0, tl[b], 0, ql[b], bands[b],
                   d.astype(np.int64), pen.W1, pen.U, pen.MM, tl[b]).score
           for b in range(len(ts))]
    assert got.cpu().tolist() == exp


def test_nw_codes_kernel_matches_plain_qext_and_oracle(cuda):
    """Kernel 4 (codes fed) equals its plain version and the qext entry
    everywhere, and nw_band inside the envelope (t_len >= band); 40,000
    and 300,000 code rows are scored too, since the kernel streams the
    rows instead of staging them."""
    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    from kma_tpu_torch.ops import nw_kernel as nk
    pen = Penalties()
    d = pen.score_matrix()
    rng = np.random.default_rng(6)
    ts, qs, tl, ql, kf, bands = [], [], [], [], [], []
    for b in range(96):
        band = [16, 32, 64, 128][b % 4]
        tlen = int(rng.integers(band, 260) if b < 80
                   else rng.integers(2, band))
        qlen = max(1, tlen + int(rng.integers(-band // 2, band // 2 + 1)))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = np.resize(t, qlen).astype(np.uint8)
        pos = rng.integers(0, qlen, qlen // 10 + 1)
        q[pos] = rng.integers(0, 5, len(pos))
        ts.append(t)
        qs.append(q)
        tl.append(tlen)
        ql.append(qlen)
        kf.append([0, 1, -1, 2, -2][b % 5])
        bands.append(band)
    kfa = np.asarray(kf, np.int32)
    staged = nk.stage_code_inputs(ts, qs, tl, ql, bands)
    C = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (staged[0], staged[1], kfa) + staged[2:]]
    kw = dict(dmat=d[:5, :5], W1=pen.W1, U=pen.U, MM=pen.MM)
    n0 = nk.nw_band_score_codes.launches
    got = nk.nw_band_score_codes(*C, **kw)
    assert nk.nw_band_score_codes.launches == n0 + 1
    assert torch.equal(got, nk.nw_band_score_codes_plain(*C, **kw))
    tl_, ql_, hb, qext, tcol = nk.stage_qext(ts, qs, tl, ql, bands)
    Q = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
         for x in (tl_, ql_, kfa, hb, qext, tcol)]
    assert torch.equal(got, nk.nw_band_score_qext(*Q, **kw))
    exp = [nw_band(ts[b], qs[b], kf[b], 0, tl[b], 0, ql[b], bands[b],
                   d.astype(np.int64), pen.W1, pen.U, pen.MM, tl[b]).score
           for b in range(80)]
    assert got.cpu().tolist()[:80] == exp
    # many code rows: the kernel streams them, so no R is refused
    args = (C[0][:2], C[1][:2], C[2][:2], C[3][:2], C[4][:2].contiguous())
    for R in (40000, 300000):
        tcol_big = torch.zeros((R, 2), dtype=torch.uint8, device=cuda)
        assert torch.equal(
            nk.nw_band_score_codes(*args, tcol_big, tcol_big, **kw),
            nk.nw_band_score_codes_plain(*args, tcol_big, tcol_big, **kw))


def test_nw_alignment_past_its_rows_is_refused(cuda):
    """t_len > R: the CPU versions raise; the card, which checks no value
    on the host, scores that alignment REFUSED and the others as
    usual."""
    from kma_tpu_torch.ops import nw_kernel as nk
    kw = dict(W1=-3, U=-1, MM=-2)
    tl = torch.tensor([5, 40], dtype=torch.int32, device=cuda)
    ql = torch.tensor([5, 5], dtype=torch.int32, device=cuda)
    kf = torch.zeros(2, dtype=torch.int32, device=cuda)
    msc = torch.ones((8, 2, 32), dtype=torch.int8, device=cuda)
    got = nk.nw_band_score(tl, ql, kf, msc, 4, **kw)
    exp = nk.nw_band_score(tl[:1].cpu(), ql[:1].cpu(), kf[:1].cpu(),
                           msc[:, :1].cpu().contiguous(), 4, **kw)
    assert got[1] == nk.REFUSED and got[0] == exp[0]
    qc0 = torch.zeros((2, 32), dtype=torch.uint8, device=cuda)
    tcol = torch.zeros((8, 2), dtype=torch.uint8, device=cuda)
    got = nk.nw_band_score_codes(tl, ql, kf, 4, qc0, tcol, tcol,
                                 dmat=np.eye(5, dtype=np.int32), **kw)
    assert got[1] == nk.REFUSED
    with pytest.raises(ValueError):
        nk.nw_band_score(tl.cpu(), ql.cpu(), kf.cpu(), msc.cpu(), 4, **kw)


def test_default_dense_budget_is_the_cards_free_memory(cuda, monkeypatch):
    """With no override the dense budget of a card is what
    torch.cuda.mem_get_info reports free when the image is built."""
    from kma_tpu_torch.mapping import scan_dense as tsd
    monkeypatch.delenv("KMA_TPU_DENSE_BUDGET_MB", raising=False)
    dev = torch.device(cuda.type, torch.cuda.current_device())
    assert tsd.device_budget(dev) == torch.cuda.mem_get_info(dev)[0]
    assert tsd._budgets((dev,), None) == (torch.cuda.mem_get_info(dev)[0],)
    assert tsd._budgets((dev, dev), None) == \
        (torch.cuda.mem_get_info(dev)[0] // 2,) * 2



@pytest.mark.parametrize("L,tier", [(128, 0), (192, 0), (256, 1)])
def test_front_and_chain_peaks_on_the_card(cuda, L, tier):
    """On the card as on the CPU (tests/test_torch_dense_budget.py), the
    front half's peak device memory (max_memory_allocated) is under its
    footprint term, and the chain lookup's under CHAIN_BYTES_A_WINDOW a
    window: 300 random templates at k 16, 512 reads cut from them."""
    from kma_tpu.index.build import freeze
    from kma_tpu.io.seq import kmer_scan, valid_kmer_mask
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.mapping.chain_device import chain_lookup
    from kma_tpu_torch.mapping.scan_common import ScanParams
    rng = np.random.default_rng(3)
    table, templates = {}, []
    for t in range(1, 301):
        seq = rng.integers(0, 4, 300).astype(np.uint8)
        templates.append(seq)
        for km in np.unique(kmer_scan(seq, 16)[valid_kmer_mask(seq, 16)]
                            ).tolist():
            table.setdefault(km, []).append(t)
    idx = freeze(table, 301, 16, 16)
    idx.template_lengths = np.full(301, 300, np.uint32)
    pen = Penalties()
    pen.score_matrix()
    B = 512
    sc = tsd.DenseScanner(idx, pen, batch=B, device=cuda)
    codes = np.stack([templates[int(rng.integers(300))][:L]
                      for _ in range(B)])
    lengths = np.full(B, L - 5, np.int32)
    codes[:, L - 5:] = 4
    p = ScanParams(*sc._sparams(L, tier))
    term = tsd.batch_workspace(2 * B, p.run_cap, sc.didx.t_pad,
                               sc.didx.t_pad, p.best_cap, tier == 0, L,
                               p.k)["front"]
    c = torch.from_numpy(codes).to(cuda)
    n = torch.from_numpy(lengths).to(cuda).long()

    def front():
        rc = torch.flip(torch.where(c < 4, 3 - c, c), dims=[-1])
        return tsd._strand_runs(torch.cat([c, rc]),
                                torch.cat([n, torch.full_like(n, L)]),
                                sc.didx, p,
                                torch.cat([torch.zeros_like(n), L - n]))

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    W = L - p.k + 1
    f_peak = peak(front)
    c_peak = peak(lambda: chain_lookup(sc.didx, c, n.int()))
    print("L %d tier %d: front %d B a row (term %d), chain %.1f B a window"
          % (L, tier, f_peak // (2 * B), term // (2 * B), c_peak / (B * W)))
    assert f_peak <= term
    assert c_peak <= tsd.CHAIN_BYTES_A_WINDOW * B * W


# -- the dense step's graphs (scan_dense.StepGraphs) -------------------------

def _graph_scanner(dev, seed=11, **kw):
    """A DenseScanner (batch 256) on a card image of 120 panel templates
    (families of 1-4 variants; multichip's seed), which replays graphs;
    reads come from ``seed``."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import SEED, _panel, \
        synthetic_index
    seqs = _panel(np.random.default_rng(SEED), 120)
    rng = np.random.default_rng(seed)
    sc = tsd.DenseScanner(synthetic_index(seqs), Penalties(), batch=256,
                          device=dev, **kw)
    assert isinstance(sc.didx.graphs, tsd.StepGraphs)
    return sc, seqs, rng


def _graph_batch(sc, rng, seqs, tier, L):
    """A batch of the daemon's shape at ``tier``: (codes, lengths on the
    card, flat_cap)."""
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import _reads
    rows = sc.batch if tier == 0 else tsd.WIDE_ROWS
    c, n = _reads(rng, seqs, rows, L)
    cap = sc.flat_headroom * rows if tier == 0 \
        else 2 * min(tsd.TIERS[1][1], sc.didx.t_pad) * rows
    dev = sc.didx.device
    return torch.from_numpy(c).to(dev), torch.from_numpy(n).to(dev), cap


def _replay_is_eager_and_plain(sc, c, n, tier, cap):
    """One batch through the scanner (a replay) against the eager step
    on the card and the plain step on CPU copies: bit for bit."""
    from kma_tpu_torch.mapping import scan_dense as tsd
    d, L = sc.didx, c.shape[1]
    got = sc._call(c, n, tier, cap)
    eager = tsd.dense_scan_device(c, n, d, **sc._statics(L, tier, cap))
    plain = sc.step(L, tier, cap)(c.cpu(), n.cpu(), d.exist.cpu(),
                                  d.kv.cpu(), d.bits.cpu())
    torch.cuda.synchronize()
    for x, y, z in zip(got, eager, plain):
        assert x.dtype == z.dtype
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    return got


def test_graphs_replay_out_of_capture_order(cuda):
    """Tier 0 and tier 1 at L 128 and 192, captured in that order into one
    shared pool, then replayed in other orders on new reads: every
    replay equals the eager step and the plain version bit for bit, no
    key is captured twice, and each replay counts its kernel launch."""
    from kma_tpu_torch.ops import scan_kernel as sk
    sc, seqs, rng = _graph_scanner(cuda)
    g = sc.didx.graphs
    keys = [(0, 128), (1, 128), (0, 192), (1, 192)]
    for tier, L in keys:
        c, n, cap = _graph_batch(sc, rng, seqs, tier, L)
        sc._call(c, n, tier, cap)
    assert len(g.graphs) == 4 and g.pool is not None
    n0 = sk.run_score_rows.launches
    mapped = 0
    for tier, L in keys[::-1] + [keys[0], keys[3], keys[1], keys[2]]:
        c, n, cap = _graph_batch(sc, rng, seqs, tier, L)
        meta, _ = _replay_is_eager_and_plain(sc, c, n, tier, cap)
        mapped += int(((meta[:, 1] & 3) != 0).sum())
    assert mapped > 0
    assert sum(g.captures.values()) == 4
    # 8 replays (one launch each) and 8 eager steps
    assert sk.run_score_rows.launches == n0 + 16
    assert g.pool_bytes() > 0


@pytest.mark.parametrize("kw", [dict(proxi_frac=0.9),
                                dict(exhaustive=True)])
def test_proxi_and_exhaustive_steps_replay(cuda, kw):
    """The proxi epilogue and the exhaustive front half hold no host sync:
    captured, their replays equal the eager step and the plain version."""
    sc, seqs, rng = _graph_scanner(cuda, seed=12, **kw)
    for tier in (0, 1):
        for _ in range(2):
            c, n, cap = _graph_batch(sc, rng, seqs, tier, 128)
            _replay_is_eager_and_plain(sc, c, n, tier, cap)
    assert sum(sc.didx.graphs.captures.values()) == 2


def test_two_requests_dispatched_before_either_resolves(cuda):
    """Two 600-read requests (three batches of one key each) dispatched
    before the first resolves, as the daemon pipelines them: each equals
    the plain scanner on the CPU."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import _reads, synthetic_index
    sc, seqs, rng = _graph_scanner(cuda, seed=13)
    reqs = [_reads(rng, seqs, 600, 128) for _ in range(2)]
    handles = [sc.scan_dispatch(c, n) for c, n in reqs]
    got = [sc.scan_resolve(h) for h in handles]
    plain = tsd.DenseScanner(synthetic_index(seqs), Penalties(), batch=256,
                             device="cpu")
    for (c, n), a in zip(reqs, got):
        b = plain.scan_reads(c, n)
        for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
            assert np.array_equal(x, y)
        for x, y in zip(a[2], b[2]):
            assert (x is None) == (y is None)
            assert x is None or np.array_equal(x, y)
        assert (a[1] != 0).sum() > 300
    assert max(sc.didx.graphs.replays.values()) >= 6


def test_failed_capture_faults_the_dense_op(cuda, tmp_path, monkeypatch):
    """A dense step that syncs the host cannot be captured: the daemon's
    dense request answers ``ok: 0``, counts a fault, and no graph is
    kept (nothing runs eager in its place)."""
    import subprocess
    import sys
    import threading
    from pathlib import Path

    from kma_tpu_torch import devserve
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import SEED, _panel, _reads
    seqs = _panel(np.random.default_rng(SEED), 60)
    rng = np.random.default_rng(14)
    fasta, prefix = tmp_path / "db.fsa", str(tmp_path / "db")
    fasta.write_text("".join(">t%d\n%s\n" % (i, "".join("ACGT"[x] for x in s))
                             for i, s in enumerate(seqs)))
    subprocess.run([sys.executable, "-m", "kma_tpu", "index", "-i",
                    str(fasta), "-o", prefix], check=True,
                   cwd=Path(__file__).resolve().parent.parent,
                   capture_output=True)
    srv = devserve.TorchDevServer(prefix, batch=64, device=cuda)
    assert srv.graphs is not None
    real = tsd.dense_scan_device

    def syncs(codes, *a, **k):
        int(codes.sum())        # a host sync: refused while capturing
        return real(codes, *a, **k)

    monkeypatch.setattr(tsd, "dense_scan_device", syncs)
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    cli = devserve.DevClient.connect(prefix, sock_path=sock)
    c, n = _reads(rng, seqs, 40, 128)
    with pytest.raises(RuntimeError, match="devserve error"):
        cli.dense_scan(c, n, Penalties(), False, None)
    cli.stop()
    th.join(timeout=30)
    assert srv.faults == {"dense": 1}
    assert not srv.graphs.graphs and not srv.graphs.replays


# -- the pair-stream step's graphs (scan_fast.FastScanner on a card image) ---

def _fast_scanner(dev, seed=21, **kw):
    """A FastScanner (batch 256) on a card image of the 120 panel
    templates above, which replays graphs; reads come from ``seed``."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.mapping import scan_fast as tsf
    from kma_tpu_torch.parallel.multichip import SEED, _panel, \
        synthetic_index
    seqs = _panel(np.random.default_rng(SEED), 120)
    sc = tsf.FastScanner(synthetic_index(seqs), Penalties(), batch=256,
                         device=dev, **kw)
    assert isinstance(sc.didx.graphs, tsd.StepGraphs)
    assert sc.didx.graphs.kernels == ()
    return sc, seqs, np.random.default_rng(seed)


def _fast_batch(sc, rng, seqs, tier, L):
    """A batch of the daemon's shape at ``tier`` (the scanner's batch, or
    a wide chunk): (codes, lengths on the card, flat_cap)."""
    from kma_tpu_torch.mapping.scan_common import WIDE_ROWS
    from kma_tpu_torch.parallel.multichip import _reads
    rows = sc.batch if tier == 0 else WIDE_ROWS
    c, n = _reads(rng, seqs, rows, L)
    cap = 8 * rows if tier == 0 else rows * 2 * sc.TIERS[1][2]
    dev = sc.didx.device
    return torch.from_numpy(c).to(dev), torch.from_numpy(n).to(dev), cap


def _fast_replay_is_eager_and_plain(sc, c, n, tier, cap):
    """One batch through the scanner (a replay) against the eager step on
    the card and the plain step on CPU copies: bit for bit."""
    from kma_tpu_torch.mapping import scan_fast as tsf
    d, L = sc.didx, c.shape[1]
    got = sc._call(c, n, tier, cap)
    eager = tsf.fast_scan_device(c, n, d, **sc._statics(tier, cap))
    plain = sc.step(L, tier, cap)(c.cpu(), n.cpu(), d.exist.cpu(),
                                  d.kv.cpu(), d.values.cpu())
    torch.cuda.synchronize()
    for x, y, z in zip(got, eager, plain):
        assert x.dtype == z.dtype
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    return got


def test_pair_stream_graphs_replay_out_of_capture_order(cuda):
    """Tier 0 and the wide tier at L 128 and 192, captured in that order
    into one shared pool, then replayed in other orders on new reads:
    every replay equals the eager step and the plain version bit for
    bit, and no key is captured twice."""
    sc, seqs, rng = _fast_scanner(cuda)
    g = sc.didx.graphs
    keys = [(0, 128), (1, 128), (0, 192), (1, 192)]
    for tier, L in keys:
        c, n, cap = _fast_batch(sc, rng, seqs, tier, L)
        sc._call(c, n, tier, cap)
    assert len(g.graphs) == 4 and g.pool is not None
    assert sorted((k.tier, k.L) for k in g.graphs) == sorted(keys)
    mapped = 0
    for tier, L in keys[::-1] + [keys[0], keys[3], keys[1], keys[2]]:
        c, n, cap = _fast_batch(sc, rng, seqs, tier, L)
        meta, _ = _fast_replay_is_eager_and_plain(sc, c, n, tier, cap)
        mapped += int(((meta[:, 1] & 3) != 0).sum())
    assert mapped > 0
    assert sum(g.captures.values()) == 4
    assert sum(g.replays.values()) == 12
    assert g.pool_bytes() > 0


@pytest.mark.parametrize("kw", [dict(proxi_frac=0.9),
                                dict(exhaustive=True)])
def test_pair_stream_proxi_and_exhaustive_steps_replay(cuda, kw):
    """The proxi threshold (a host scalar the capture bakes in; the key
    holds proxi_frac) and the exhaustive front half: captured, their
    replays equal the eager step and the plain version."""
    sc, seqs, rng = _fast_scanner(cuda, seed=22, **kw)
    for tier in (0, 1):
        for _ in range(2):
            c, n, cap = _fast_batch(sc, rng, seqs, tier, 128)
            _fast_replay_is_eager_and_plain(sc, c, n, tier, cap)
    g = sc.didx.graphs
    assert sum(g.captures.values()) == 2
    assert all(k.proxi_frac == kw.get("proxi_frac") for k in g.graphs)


def test_pair_stream_two_requests_dispatched_before_either_resolves(cuda):
    """Two 600-read requests (three tier-0 batches of one key each)
    dispatched before the first resolves, as the daemon pipelines them:
    each equals the plain scanner on the CPU."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_fast as tsf
    from kma_tpu_torch.parallel.multichip import _reads, synthetic_index
    sc, seqs, rng = _fast_scanner(cuda, seed=23)
    reqs = [_reads(rng, seqs, 600, 128) for _ in range(2)]
    handles = [sc.scan_dispatch(c, n) for c, n in reqs]
    got = [sc.scan_resolve(h) for h in handles]
    plain = tsf.FastScanner(synthetic_index(seqs), Penalties(), batch=256,
                            device="cpu")
    assert plain.didx.graphs is None
    for (c, n), a in zip(reqs, got):
        b = plain.scan_reads(c, n).lists()
        for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
            assert np.array_equal(x, y)
        for x, y in zip(a[2], b[2]):
            assert (x is None) == (y is None)
            assert x is None or np.array_equal(x, y)
        assert (a[1] != 0).sum() > 300
    g = sc.didx.graphs
    assert max(g.replays[k] for k in g.graphs if k.tier == 0) >= 6


def test_pair_stream_failed_capture_faults_the_dense_op(cuda, tmp_path,
                                                        monkeypatch):
    """On a pair-stream daemon (a dense budget of 0), a step that syncs
    the host cannot be captured: the dense request answers ``ok: 0``,
    counts a fault, and no graph is kept (nothing runs eager in its
    place)."""
    import subprocess
    import sys
    import threading
    from pathlib import Path

    from kma_tpu_torch import devserve
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_fast as tsf
    from kma_tpu_torch.parallel.multichip import SEED, _panel, _reads
    seqs = _panel(np.random.default_rng(SEED), 60)
    rng = np.random.default_rng(24)
    fasta, prefix = tmp_path / "db.fsa", str(tmp_path / "db")
    fasta.write_text("".join(">t%d\n%s\n" % (i, "".join("ACGT"[x] for x in s))
                             for i, s in enumerate(seqs)))
    subprocess.run([sys.executable, "-m", "kma_tpu", "index", "-i",
                    str(fasta), "-o", prefix], check=True,
                   cwd=Path(__file__).resolve().parent.parent,
                   capture_output=True)
    monkeypatch.setenv("KMA_TPU_DENSE_BUDGET_MB", "0")
    srv = devserve.TorchDevServer(prefix, batch=64, device=cuda)
    monkeypatch.delenv("KMA_TPU_DENSE_BUDGET_MB")
    assert srv.scanner_kind == "pair_stream" and srv.graphs is not None
    real = tsf.fast_scan_device

    def syncs(codes, *a, **k):
        int(codes.sum())        # a host sync: refused while capturing
        return real(codes, *a, **k)

    monkeypatch.setattr(tsf, "fast_scan_device", syncs)
    sock = str(tmp_path / "d.sock")
    up = threading.Event()
    th = threading.Thread(target=srv.serve, daemon=True, kwargs={
        "sock_path": sock, "ready_cb": up.set})
    th.start()
    assert up.wait(30)
    cli = devserve.DevClient.connect(prefix, sock_path=sock)
    c, n = _reads(rng, seqs, 40, 128)
    with pytest.raises(RuntimeError, match="devserve error"):
        cli.dense_scan(c, n, Penalties(), False, None)
    cli.stop()
    th.join(timeout=30)
    assert srv.faults == {"dense": 1}
    assert not srv.graphs.graphs and not srv.graphs.replays


# -- the sharded dense step's graphs (scan_dense.ShardedStep) ----------------

def _sharded_scanner(dev, seed=31, **kw):
    """A DenseScanner (batch 256) on the 120 panel templates sharded over
    every card (two entries of the one card on a one-card machine) under
    a budget one card's footprint exceeds, which replays its segments'
    graphs; the same scanner unsharded on the CPU."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import SEED, _panel, \
        synthetic_index
    seqs = _panel(np.random.default_rng(SEED), 120)
    idx = synthetic_index(seqs)
    n_cards = torch.cuda.device_count()
    devs = ["cuda:%d" % (i % n_cards) for i in range(max(2, n_cards))]
    budget = max(f.total for f in tsd.image_footprint(idx, len(devs), 256))
    assert budget < tsd.image_footprint(idx, 1, 256)[0].total
    sc = tsd.DenseScanner(idx, Penalties(), batch=256, devices=devs,
                          mem_budget_bytes=budget, **kw)
    assert sc.didx.sharded and isinstance(sc.didx.graphs, tsd.StepGraphs)
    plain = tsd.DenseScanner(idx, Penalties(), batch=256, device="cpu",
                             **kw)
    return sc, plain, seqs, np.random.default_rng(seed)


@pytest.mark.parametrize("kw", [{}, dict(proxi_frac=0.9)])
def test_sharded_graphs_replay_as_eager(cuda, kw):
    """Tier 0 and tier 1 at L 128 and 192, captured, then replayed in
    other orders on new reads: every replay equals the eager sharded
    step and the unsharded plain scanner on the CPU bit for bit; each
    replay counts one run-scoring launch and call a shard."""
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.ops import scan_kernel as sk
    sc, plain, seqs, rng = _sharded_scanner(cuda, **kw)
    d, g = sc.didx, sc.didx.graphs
    keys = [(0, 128), (1, 128), (0, 192), (1, 192)]
    for tier, L in keys:
        c, n, cap = _graph_batch(sc, rng, seqs, tier, L)
        sc._call(c, n, tier, cap)
    assert len(g.graphs) == 4 and g.pool is not None
    n_db = len(d.devices)
    mapped = 0
    for tier, L in keys[::-1] + [keys[0], keys[3]]:
        c, n, cap = _graph_batch(sc, rng, seqs, tier, L)
        calls0, n0 = list(d.shard_calls), sk.run_score_rows.launches
        got = sc._call(c, n, tier, cap)
        torch.cuda.synchronize()
        assert sk.run_score_rows.launches == n0 + n_db
        assert d.shard_calls == [x + 1 for x in calls0]
        eager = tsd.dense_scan_device(c, n, d, **sc._statics(L, tier, cap))
        want = plain._call(c.cpu(), n.cpu(), tier, cap)
        torch.cuda.synchronize()
        for x, y, z in zip(got, eager, want):
            assert x.dtype == z.dtype
            assert torch.equal(x, y) and torch.equal(x.cpu(), z)
        mapped += int(((got[0][:, 1] & 3) != 0).sum())
    assert mapped > 0
    assert sum(g.captures.values()) == 4
    assert g.pool_bytes() > 0


def test_sharded_requests_dispatched_before_either_resolves(cuda):
    """Two 600-read requests on the sharded image dispatched before the
    first resolves: each equals the plain scanner on the CPU."""
    sc, plain, seqs, rng = _sharded_scanner(cuda, seed=32)
    from kma_tpu_torch.parallel.multichip import _reads
    reqs = [_reads(rng, seqs, 600, 128) for _ in range(2)]
    handles = [sc.scan_dispatch(c, n) for c, n in reqs]
    got = [sc.scan_resolve(h) for h in handles]
    for (c, n), a in zip(reqs, got):
        b = plain.scan_reads(c, n)
        for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
            assert np.array_equal(x, y)
        for x, y in zip(a[2], b[2]):
            assert (x is None) == (y is None)
            assert x is None or np.array_equal(x, y)
        assert (a[1] != 0).sum() > 300
    assert max(sc.didx.graphs.replays.values()) >= 6


def test_failed_sharded_capture_keeps_no_key(cuda, monkeypatch):
    """A segment that syncs the host cannot be captured: the batch raises
    (the daemon's op faults) and the key keeps no graph."""
    from kma_tpu_torch.mapping import scan_dense as tsd
    sc, _, seqs, rng = _sharded_scanner(cuda, seed=33)
    real = tsd.ShardedStep.best

    def syncs(self, maxima, *a):
        int(maxima.sum())        # a host sync: refused while capturing
        return real(self, maxima, *a)

    monkeypatch.setattr(tsd.ShardedStep, "best", syncs)
    c, n, cap = _graph_batch(sc, rng, seqs, 0, 128)
    with pytest.raises(RuntimeError):
        sc._call(c, n, 0, cap)
    assert not sc.didx.graphs.graphs and not sc.didx.graphs.replays


# -- the chain op's graphs (chain_device.chain_graphs) ------------------------

def test_chain_graphs_replay_as_eager(cuda):
    """Requests of 2,048 and 16,384 rows and their short tails at L 128:
    replayed from one graph a rows class, each reply equal to the eager
    lookup on the card and to the lookup on the CPU."""
    from kma_tpu_torch.mapping import chain_device as tcd
    from kma_tpu_torch.mapping import scan_dense as tsd
    from kma_tpu_torch.parallel.multichip import SEED, _panel, _reads, \
        synthetic_index
    seqs = _panel(np.random.default_rng(SEED), 120)
    idx = synthetic_index(seqs)
    d = tsd.DenseIndex.from_host(idx, cuda)
    cpu = tsd.DenseIndex.from_host(idx, "cpu")
    g = d.chain_graphs
    assert g is not None and g.pools is d.graphs.pools
    rng = np.random.default_rng(41)
    for n in (2048, 700, 16384, 5000, 2048):
        c, ln = _reads(rng, seqs, n, 128)
        got = tcd.chain_lookup_dense(d, idx, c, ln)
        eager = tcd.chain_lookup(d, torch.from_numpy(c).to(cuda),
                                 torch.from_numpy(ln).to(cuda))
        want = tcd.chain_lookup_dense(cpu, idx, c, ln)
        for a, b, z in zip(got, eager, want):
            assert np.array_equal(a, b.cpu().numpy())
            assert np.array_equal(a, z)
        assert (got[0] >= 0).sum() > 0
    assert sorted(k[5] for k in g.graphs) == [2048, 16384]
    assert sum(g.captures.values()) == 2 and sum(g.replays.values()) == 5
