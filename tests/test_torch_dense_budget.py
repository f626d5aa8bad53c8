"""The dense image's footprint on the device and the budget it is held
to (kma_tpu_torch/mapping/scan_dense.py).

Each footprint term equals the bytes of the tensors the scanner
allocates for a CPU batch at the same G, R and t_pad (tolerance 0: they
are byte counts).  ``dense_image`` takes one device when the port's
footprint fits, although the JAX package's figure V·t_pad·2 does not;
shards when one device's budget is exceeded and n devices' are not;
refuses past that (the daemon then takes the pair-stream scanner).
``KMA_TPU_DENSE_BUDGET_MB`` still overrides the device's own budget."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from kma_tpu.index.build import freeze
from kma_tpu.io.seq import kmer_scan, valid_kmer_mask
from kma_tpu_torch.config import Penalties
from kma_tpu_torch.mapping import scan_dense as tsd
from kma_tpu_torch.mapping.scan_common import ScanParams

from test_torch_scan_dense_sharded import _family_db, _reads


@pytest.fixture(scope="module")
def family():
    return _family_db(300, 3)


@pytest.fixture(scope="module")
def wide_db():
    """300,000 k-mers on lists of 1-4 of 4,000 templates: V·t_pad·2 is
    over the port's footprint (V/8 bytes of bits a template, two
    wide-tier batches)."""
    rng = np.random.default_rng(21)
    kms = rng.choice(1 << 32, 300_000, replace=False)
    table = {int(km): sorted(set(rng.integers(1, 4001, 4)[
        : int(rng.integers(1, 5))].tolist())) for km in kms}
    idx = freeze(table, 4001, 16, 16)
    idx.template_lengths = np.full(4001, 300, np.uint32)
    return idx


def _k12_db(mega):
    """120 random 300 bp templates indexed at k 12, on the hashed table
    or the direct-addressed (mega) one (4**12 slots, 64 MB)."""
    rng = np.random.default_rng(5)
    table, templates = {}, [None]
    for t in range(1, 121):
        codes = rng.integers(0, 4, 300).astype(np.uint8)
        templates.append(codes)
        kms = kmer_scan(codes, 12)[valid_kmer_mask(codes, 12)]
        for km in np.unique(kms).tolist():
            table.setdefault(km, []).append(t)
    idx = freeze(table, 121, 12, 12, mega=mega)
    idx.template_lengths = np.full(121, 300, np.uint32)
    return idx, templates


def _pen():
    pen = Penalties()
    pen.score_matrix()
    return pen


def _peak_bytes(fn) -> int:
    """The most bytes ``fn`` holds allocated at once on the CPU: the
    running total of the allocations torch.profiler records."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    allocs = []

    def walk(node):
        ef = node.extra_fields
        if type(ef).__name__ == "_ExtraFields_Allocation":
            allocs.append((node.start_time_ns, ef.alloc_size,
                           ef.total_allocated))
        for child in node.children:
            walk(child)

    for root in prof.profiler.kineto_results.experimental_event_tree():
        walk(root)
    allocs.sort()
    base = allocs[0][2] - allocs[0][1]
    return max(total for _, _, total in allocs) - base


def _front_half(sc, codes, lengths, tier):
    """dense_scan_device's front half of one batch: the strands' codes
    and _strand_runs."""
    c = torch.from_numpy(codes)
    n = torch.from_numpy(lengths).long()
    L = c.shape[1]
    p = ScanParams(*sc._sparams(L, tier))
    rc = torch.flip(torch.where(c < 4, 3 - c, c), dims=[-1])
    return tsd._strand_runs(torch.cat([c, rc]),
                            torch.cat([n, torch.full_like(n, L)]), sc.didx,
                            p, torch.cat([torch.zeros_like(n), L - n]))


class _Spy:
    """Records the tensors one scanner call allocates (run-scoring
    inputs and outputs, the clip mask, the chosen rows, the tie key)."""

    def __init__(self, monkeypatch):
        self.seen = {}
        monkeypatch.setattr(tsd, "run_score_rows", self._wrap(
            "run_score_rows", tsd.run_score_rows))
        clip, key, ties = tsd._clip_score, tsd._tie_key, tsd._shard_ties

        def clip_spy(shards):
            out = clip(shards)
            self.seen["inc"] = out[0][3]
            return out

        def key_spy(sc, fi, inc, *a, **kw):
            self.seen["sc_fi"] = (sc, fi, inc)
            n_best, k = key(sc, fi, inc, *a, **kw)
            self.seen["key"] = k
            return n_best, k

        def ties_spy(*a, **kw):
            out = ties(*a, **kw)
            self.seen["cand"] = out[1:]
            return out

        monkeypatch.setattr(tsd, "_clip_score", clip_spy)
        monkeypatch.setattr(tsd, "_tie_key", key_spy)
        monkeypatch.setattr(tsd, "_shard_ties", ties_spy)

    def _wrap(self, name, fn):
        def spy(words, *a, **kw):
            score, first = fn(words, *a, **kw)
            self.seen["words"] = (name, words)
            self.seen["out"] = (score, first)
            return score, first
        return spy


@pytest.mark.parametrize("tier", [0, 1])
def test_terms_are_the_tensors_a_batch_allocates(family, tier, monkeypatch):
    idx, templates = family
    B, L = 24, 80
    sc = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")
    d = sc.didx
    codes, lengths = _reads(templates, B, L, 5)
    spy = _Spy(monkeypatch)
    sc._call(torch.from_numpy(codes), torch.from_numpy(lengths), tier,
             24 * B)
    p = ScanParams(*sc._sparams(L, tier))
    G, R = 2 * B, p.run_cap
    terms = tsd.batch_workspace(G, R, d.t_pad, d.t_pad, p.best_cap,
                                tier == 0, L, d.kmersize)
    s = spy.seen
    name, words = s["words"]
    assert name == "run_score_rows" and words is d.bits
    assert terms["score_first"] == sum(t.nbytes for t in s["out"])
    assert terms["clip_masks"] == 2 * s["inc"].nbytes
    rows_sc, rows_fi, inc = s["sc_fi"]
    if tier == 0:
        assert terms["chosen_rows"] == rows_sc.nbytes + rows_fi.nbytes
        assert inc is None and rows_sc.shape == (B, d.t_pad)
    else:
        assert terms["chosen_rows"] == 0 and inc is s["inc"]
    assert terms["keys"] == s["key"].nbytes
    assert s["key"].dtype == torch.int64
    assert terms["tie_masks"] == 3 * s["key"].nbytes // 8
    topv, ids = s["cand"]
    assert topv.shape[1] == min(p.best_cap, d.t_pad)
    assert terms["candidates"] == 3 * (topv.nbytes + ids.nbytes)
    W = L - d.kmersize + 1
    assert terms["front"] == G * (tsd.FRONT_BYTES_A_WINDOW * W
                                  + tsd.FRONT_BYTES_A_RUN * (R + 1))
    # the front half's measured peak, within 10 % under its term
    peak = _peak_bytes(lambda: _front_half(sc, codes, lengths, tier))
    assert peak <= terms["front"] <= 1.1 * peak


@pytest.mark.parametrize("n", [1, 2, 4])
def test_every_shard_is_read_in_place(family, n, monkeypatch):
    """A batch scores each shard's runs from the shard's own table
    (run_score_rows), so no term of the footprint holds gathered rows;
    the scan equals the unsharded one."""
    idx, templates = family
    B, L = 24, 80
    d = tsd.DenseIndex.from_host(idx, None if n > 1 else "cpu",
                                 devices=["cpu"] * n if n > 1 else None,
                                 batch=B)
    assert len(d.shard_bits) == n
    seen = []
    rows = tsd.run_score_rows

    def spy(tab, *a, **kw):
        seen.append(tab)
        return rows(tab, *a, **kw)

    monkeypatch.setattr(tsd, "run_score_rows", spy)
    codes, lengths = _reads(templates, B, L, 11)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    got = tsd.DenseScanner(None, _pen(), batch=B, didx=d)._call(c, ln, 0,
                                                                24 * B)
    assert len(seen) == n
    assert all(t is b for t, b in zip(seen, d.shard_bits))
    assert "gather" not in d.footprint[0].batch
    want = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")._call(
        c, ln, 0, 24 * B)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_image_terms_are_its_tensors(family, n):
    """Bits a shard and the primary's hash tables are the image's own
    tensors; the workspace is the larger tier's at the image's batch."""
    idx, _ = family
    d = tsd.DenseIndex.from_host(idx, None if n > 1 else "cpu",
                                 devices=["cpu"] * n if n > 1 else None,
                                 batch=64)
    assert d.footprint == tsd.image_footprint(idx, n, 64)
    for s, (f, b) in enumerate(zip(d.footprint, d.shard_bits)):
        assert f.bits == b.nbytes
        assert f.hash == (d.exist.nbytes + d.kv.nbytes if s == 0 else 0)
        assert f.ops == ((tsd.CHAIN_BYTES_A_WINDOW + tsd.CHAIN_GRAPHS
                          * tsd.CHAIN_GRAPH_BYTES_A_WINDOW)
                         * tsd.CHAIN_WINDOWS if s == 0 else 0)
        # the step graphs' inputs, outputs and copies; a sharded image's
        # plans' buffers a shard
        assert f.graphs == (tsd.graph_bytes(64, d.t_pad, k=d.kmersize)
                            if n == 1 else tsd.plan_bytes(
                                64, d.t_pad, n, k=d.kmersize)[s])
        assert f.total == f.bits + f.hash + 2 * f.workspace + f.ops \
            + f.graphs
    ws = [sum(tsd.batch_workspace(
        2 * rows, min(rc, tsd.FOOTPRINT_READ_PAD - d.kmersize + 1),
        d.t_pad // n, d.t_pad, bc, tier == 0,
        tsd.FOOTPRINT_READ_PAD, d.kmersize).values())
        for tier, ((rc, bc), rows) in enumerate(zip(tsd.TIERS,
                                                    (64, 512)))]
    assert d.footprint[0].workspace == max(ws)


def test_one_device_where_the_jax_figure_is_over(wide_db):
    idx = wide_db
    fp = tsd.image_footprint(idx, 1, 64)[0]
    d = tsd.dense_image(idx, "cpu", fp.total, batch=64)
    assert not d.sharded and d.budget == (fp.total,)
    assert d.n_lists * d.t_pad * 2 > fp.total
    with pytest.raises(NotImplementedError, match="dense membership"):
        tsd.dense_image(idx, "cpu", fp.total - 1, batch=64)


@pytest.mark.parametrize("db", ["family", "wide_db"])
@pytest.mark.parametrize("n", [2, 4])
def test_shards_when_one_budget_is_exceeded(db, n, request):
    """One device, then n, then none: the fallback order."""
    idx = request.getfixturevalue(db)
    idx = idx[0] if isinstance(idx, tuple) else idx
    budget = max(f.total for f in tsd.image_footprint(idx, n, 64))
    assert budget < tsd.image_footprint(idx, 1, 64)[0].total
    d = tsd.dense_image(idx, "cpu", budget, devices=["cpu"] * n, batch=64)
    assert d.sharded and len(d.shard_bits) == n
    assert d.budget == (budget,) * n
    assert all(f.total <= budget for f in d.footprint)
    with pytest.raises(NotImplementedError, match="dense membership"):
        tsd.dense_image(idx, "cpu", budget - 1, devices=["cpu"] * n,
                        batch=64)


def test_env_budget_overrides(family, monkeypatch):
    idx, _ = family
    need = tsd.image_footprint(idx, 1, 64)[0].total
    monkeypatch.setenv("KMA_TPU_DENSE_BUDGET_MB", str((need >> 20) - 1))
    with pytest.raises(NotImplementedError, match="dense membership"):
        tsd.DenseIndex.from_host(idx, "cpu", batch=64)
    monkeypatch.setenv("KMA_TPU_DENSE_BUDGET_MB", str((need >> 20) + 1))
    d = tsd.DenseIndex.from_host(idx, "cpu", batch=64)
    assert d.budget == (((need >> 20) + 1) << 20,)
    # an explicit byte budget wins over the variable
    d = tsd.DenseIndex.from_host(idx, "cpu", need, batch=64)
    assert d.budget == (need,)


def test_default_budget_is_the_device_memory(family, monkeypatch):
    """The host's physical memory on the CPU, split over the entries of
    ``devices`` that name one device."""
    monkeypatch.delenv("KMA_TPU_DENSE_BUDGET_MB", raising=False)
    idx, _ = family
    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert tsd.device_budget(torch.device("cpu")) == phys
    assert tsd.DenseIndex.from_host(idx, "cpu").budget == (phys,)
    d = tsd.DenseIndex.from_host(idx, None, devices=["cpu"] * 2)
    assert d.budget == (phys // 2,) * 2


def test_table_built_in_chunks_equals_one_pass(family, monkeypatch):
    """The on-device build in row chunks (here 3 rows a chunk) gives the
    table of one pass, sharded or not."""
    idx, _ = family
    whole = tsd.DenseIndex.from_host(idx, "cpu")
    monkeypatch.setattr(tsd, "_BUILD_CHUNK_WORDS", 3 * whole.t_pad // 32)
    assert torch.equal(tsd.DenseIndex.from_host(idx, "cpu").bits,
                       whole.bits)
    sh = tsd.DenseIndex.from_host(idx, None, devices=["cpu"] * 3)
    assert torch.equal(torch.cat(sh.shard_bits, dim=1), whole.bits)


def test_table_equals_or_of_its_lists(family):
    """The table equals a bitwise OR over every (list, template) entry,
    also for a list that names one template twice (index_add_ alone
    would carry into the next bit)."""
    idx, _ = family
    values = np.asarray(idx.values, np.int64).copy()
    offs = np.unique(idx.value_index[: idx.n]).astype(np.int64)
    v = offs[np.flatnonzero(values[offs] >= 2)[0]]
    values[v + 2] = values[v + 1]
    cnts = values[offs]
    t_pad = 384
    got = tsd._membership_bits(values, offs, cnts, t_pad,
                               (torch.device("cpu"),))[0]
    exp = np.zeros((len(offs), t_pad // 32), np.uint32)
    for r, (o, c) in enumerate(zip(offs, cnts)):
        for t in values[o + 1: o + 1 + c]:
            exp[r, t // 32] |= np.uint32(1) << np.uint32(t % 32)
    assert np.array_equal(got.numpy().view(np.uint32), exp)


@pytest.mark.parametrize("mega", [False, True])
@pytest.mark.parametrize("L", [64, 160, 256])
@pytest.mark.parametrize("tier", [0, 1])
def test_front_peak_is_under_its_term(mega, L, tier):
    """The front half's measured peak a strand row is under its term at
    every read pad, both tiers, on both hash tables (the constants are
    that measurement, rounded up)."""
    idx, templates = _k12_db(mega)
    B = 16
    sc = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")
    assert sc.didx.mega == mega
    codes, lengths = _reads(templates, B, L, 7)
    p = ScanParams(*sc._sparams(L, tier))
    term = tsd.batch_workspace(2 * B, p.run_cap, sc.didx.t_pad,
                               sc.didx.t_pad, p.best_cap, tier == 0, L,
                               p.k)["front"]
    peak = _peak_bytes(lambda: _front_half(sc, codes, lengths, tier))
    assert peak <= term <= 1.1 * peak


@pytest.mark.parametrize("mega", [False, True])
def test_chain_chunk_peak_is_its_term(mega, monkeypatch):
    """The chain op's measured peak is under CHAIN_BYTES_A_WINDOW a
    window; chunked by CHAIN_WINDOWS, its reply equals one pass."""
    from kma_tpu_torch.mapping import chain_device as cd
    idx, templates = _k12_db(mega)
    d = tsd.DenseIndex.from_host(idx, "cpu")
    codes, lengths = _reads(templates, 40, 128, 9)
    W = 128 - d.kmersize + 1
    peak = _peak_bytes(lambda: cd.chain_lookup(
        d, torch.from_numpy(codes), torch.from_numpy(lengths)))
    assert peak <= tsd.CHAIN_BYTES_A_WINDOW * 40 * W
    whole = cd.chain_lookup_dense(d, idx, codes, lengths)
    monkeypatch.setattr(cd, "CHAIN_WINDOWS", 3 * W)
    for a, b in zip(cd.chain_lookup_dense(d, idx, codes, lengths), whole):
        assert np.array_equal(a, b)


def test_long_reads_take_fewer_rows_a_batch(family, monkeypatch):
    """Reads past the footprint's pad go in batches of fewer rows
    (batch_rows), with the results of full batches."""
    idx, templates = family
    assert tsd.batch_rows(64, 256, 16) == 64
    assert tsd.batch_rows(64, 512, 16) == 64 * 241 // 497
    assert tsd.batch_rows(64, 1 << 20, 16) == 1
    B, L = 48, 250
    codes, lengths = _reads(templates, B, L, 11)
    full = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")
    exp = full.scan_reads(codes, lengths)
    assert full.tier0_batches == 1
    monkeypatch.setattr(tsd, "FOOTPRINT_READ_PAD", 96)
    cut = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")
    got = cut.scan_reads(codes, lengths)
    assert cut.tier0_batches == -(-B // tsd.batch_rows(B, L, 16)) > 1
    for g, e in zip(got[:2] + got[3:], exp[:2] + exp[3:]):
        assert np.array_equal(g, e)
    assert all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(got[2], exp[2]))


def test_batch_peak_is_under_its_workspace(family):
    """A whole tier-0 batch's measured peak is under the sum of its
    workspace terms."""
    idx, templates = family
    B, L = 24, 128
    sc = tsd.DenseScanner(idx, _pen(), batch=B, device="cpu")
    codes, lengths = _reads(templates, B, L, 13)
    p = ScanParams(*sc._sparams(L, 0))
    ws = tsd.batch_workspace(2 * B, p.run_cap, sc.didx.t_pad, sc.didx.t_pad,
                             p.best_cap, True, L, p.k)
    peak = _peak_bytes(lambda: sc._call(torch.from_numpy(codes),
                                        torch.from_numpy(lengths), 0,
                                        24 * B))
    assert peak <= sum(ws.values())
