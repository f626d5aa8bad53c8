"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its
generators write bench.py's files, its parity rule, its NW and scan
sections against the JAX package's host oracles, and the whole program
at a tiny size against a CPU daemon with the kernels' plain versions."""

import ast
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from kma_tpu_torch.ops import nw_kernel as nk

from test_torch_devserve import REPO, native_cli  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """chip_smoke's panel generator at 12 templates, indexed."""
    from kma_tpu.cli.main import index_main
    d = tmp_path_factory.mktemp("bench_panel")
    fasta = str(d / "panel.fsa")
    bt._smoke().make_panel(fasta, np, 12)
    db = str(d / "panel")
    assert index_main(["-i", fasta, "-o", db]) == 0
    return fasta, db


@pytest.fixture
def front_end_env(tmp_path, monkeypatch):
    """chip_smoke's environment of the JAX package's programs (a jax
    that refuses to import); the daemon directory it sets is restored."""
    monkeypatch.setenv("KMA_DEVSERVE_DIR", str(tmp_path / "sock"))
    return bt._smoke().front_end_env(str(tmp_path / "work"))


def test_scale_one_is_bench_py():
    assert bt.sizes(1) == {"templates": 2250, "reads": bench.N_READS,
                           "pairs": bench.N_PAIRS, "ont": bench.N_ONT,
                           "nw_b": 2048, "sample": 500}
    assert (bt.READ_LEN, bt.BATCH) == (bench.READ_LEN, bench.BATCH)


@pytest.mark.parametrize("which", ["se", "pe", "ont"])
def test_generators_write_bench_py_files(panel, which, monkeypatch,
                                         tmp_path):
    """The same fasta gives the same reads files as bench.py's
    ``_gen_se``, ``_gen_pe`` and ``_gen_ont``."""
    fasta, _ = panel
    n = {"se": 60, "pe": 40, "ont": 8}[which]
    monkeypatch.setattr(bench, {"se": "N_READS", "pe": "N_PAIRS",
                                "ont": "N_ONT"}[which], n)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if which == "pe":
        bench._gen_pe(fasta, a + "_1", a + "_2")
        bt.gen_pe(fasta, b + "_1", b + "_2", n)
        pairs = [(a + s, b + s) for s in ("_1", "_2")]
    else:
        getattr(bench, "_gen_" + which)(fasta, a)
        getattr(bt, "gen_" + which)(fasta, b, n)
        pairs = [(a, b)]
    for x, y in pairs:
        with open(x, "rb") as f, open(y, "rb") as g:
            want = f.read()
            assert want == g.read()
        assert want.count(b"\n+\n") == n


@pytest.fixture
def outputs(tmp_path):
    """Prefixes a and b with equal artifacts: a .res, a gzip member
    written under other names and times, a .mapstat whose command and
    date lines differ."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for p, stamp in ((a, 1), (b, 2)):
        with open(p + ".res", "wb") as f:
            f.write(b"#Template\tScore\ntpl1\t900\n")
        with gzip.GzipFile(p + ".mat.gz", "wb", mtime=stamp) as f:
            f.write(b"#tpl1\nA\t5\t0\t0\t0\t0\t0\n")
        with open(p + ".mapstat", "wb") as f:
            f.write(b"## method\tKMA\n## command\tkma -o %s\n## date\t%d\n"
                    b"# refSequence\treadCount\ntpl1\t10\n"
                    % (p.encode(), stamp))
    return a, b


EXTS = (".res", ".mat.gz", ".mapstat")


def test_parity_ignores_gzip_headers_and_mapstat_echo(outputs):
    a, b = outputs
    with open(a + ".mat.gz", "rb") as f, open(b + ".mat.gz", "rb") as g:
        assert f.read() != g.read()
    assert bt.mismatch(a, b, EXTS) is None


@pytest.mark.parametrize("ext,line", [(".res", 1), (".mat.gz", 1),
                                      (".mapstat", 4)])
def test_parity_finds_a_changed_byte(outputs, ext, line):
    """A byte changed in .res, in a gzip member and in a .mapstat body
    line is found."""
    a, b = outputs
    path = b + ext
    opener = gzip.open if ext.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    lines[line] = lines[line][:-1] + b"7"
    with opener(path, "wb") as f:
        f.write(b"\n".join(lines))
    assert bt.mismatch(a, b, EXTS) == ext
    os.remove(a + ".res")
    assert bt.mismatch(a, b, EXTS).startswith(".res (")


def test_a_mismatch_zeroes_the_row_and_fails_the_run():
    rows = {name: {"reads_per_sec": 10.0, "vs_host": 1.0, "parity": True}
            for name in bt.E2E}
    rows["mh_scaling"] = {"not_ported": bt.MH_NOT_PORTED}
    out, rc = bt.result(rows, [])
    assert rc == 0 and out["failed"] == [] and out["value"] == 10.0
    assert out["vs_baseline"] == pytest.approx(1.0)
    bt.apply_parity(rows["pe_apm"], ".res", ("reads_per_sec", "vs_host"))
    assert rows["pe_apm"]["parity"] is False
    assert rows["pe_apm"]["reads_per_sec"] == rows["pe_apm"]["vs_host"] == 0
    out, rc = bt.result(rows, [])
    assert rc == 1 and out["failed"] == ["pe_apm"]
    assert out["vs_baseline"] == 0.0
    # a sub-row's parity and a skipped section fail the run too
    rows["pe_apm"] = {"vs_host": 1.0, "parity": True}
    rows["device_e2e"] = {"nw_prepass": {"parity": False}}
    rows["nw_kernel"] = {"skipped": "section deadline (420 s)"}
    assert bt.result(rows, [])[0]["failed"] == ["device_e2e", "nw_kernel"]
    assert bt.result({}, ["jax"])[1] == 1


def test_daemon_start_split_is_parsed():
    got = bt.parse_start(
        "# device scanner: dense image\n# kma_tpu_torch run: daemon start "
        "12.50 s (set-up 7.80, CUDA init 0.30, kernel load 0.10, index "
        "read 0.20, image build 2.40, warm-up 1.70)\n")
    assert got["daemon_start_s"] == 12.5
    assert got["split_s"]["image build"] == 2.4
    assert list(got["split_s"]) == ["set-up", "CUDA init", "kernel load",
                                    "index read", "image build", "warm-up"]


def test_nw_scores_equal_nw_band():
    """The slab entry on bench.py's windows (staged with stage_qext,
    expanded by expand_qext), and the qext entry, equal the host oracle
    nw_band on every window."""
    from kma_tpu.align.nw import nw_band
    from kma_tpu.config import Penalties
    ts, qs = bt.nw_problem(24)
    x = bt.nw_operands(torch, CPU, ts, qs)
    p = x.pen
    got = nk.nw_band_score(x.tl, x.ql, x.kf, x.msc, x.hb, p.W1, p.U, p.MM)
    q = nk.nw_band_score_qext(x.tl, x.ql, x.kf, x.hb, x.qext, x.tcol,
                              dmat=x.d, W1=p.W1, U=p.U, MM=p.MM)
    pen = Penalties()
    d = pen.score_matrix()[:5, :5].astype(np.int8)
    want = [int(nw_band(t, s, -1, 0, bt.NW_T_LEN, 0, bt.NW_Q_LEN,
                        bt.NW_BAND, d, pen.W1, pen.U, pen.MM,
                        bt.NW_T_LEN).score) for t, s in zip(ts, qs)]
    assert got.tolist() == want == q.tolist()


def test_nw_section_on_the_cpu(front_end_env):
    """The section's own checks (plain version, nw_band as a program)
    pass, and a CPU run records no device metric."""
    row = bt.nw_section(torch, CPU, {"nw_b": 40}, front_end_env)
    assert row["exact"] and row["exact_plain"] and row["exact_nw_band"]
    assert row["oracle_windows"] == 3
    assert "cell_updates_per_sec" not in row and row["not_measured"]


def test_device_scan_equals_save_kmers_scanner(panel, tmp_path):
    """The port's DenseScanner on the CPU, as the section runs it,
    equals SaveKmersScanner in this process on the sample, and a changed
    template list is caught."""
    from kma_tpu.config import Penalties
    from kma_tpu.index.format import load_index
    from kma_tpu.io.pipeline import iter_reads
    from kma_tpu.mapping.scan import SaveKmersScanner
    fasta, db = panel
    reads = str(tmp_path / "r.fq")
    bt.gen_se(fasta, reads, 300)
    _sc, codes, lengths, res, ws, sample = bt.scan_sample(
        torch, CPU, db, reads, 40)
    assert len(ws) == bt.REPS and len(sample) == 40
    pen = Penalties()
    pen.score_matrix()
    host = SaveKmersScanner(load_index(db), pen)
    rs = list(iter_reads([reads]))
    hits = {}
    for i in sample:
        h = host.scan(rs[i].codes, rs[i].n_positions, rs[i].header)
        hits[str(i)] = None if h is None else [
            int(h.rc_flag), [int(t) for t in h.templates]]
    got = {"n": len(rs), "hits": hits,
           "lengths": {str(i): len(rs[i].codes) for i in sample}}
    assert sum(h is not None for h in hits.values()) > 30
    assert bt.scan_parity(res, lengths, got, sample) is None
    i = next(i for i in sample if hits[str(i)] is not None)
    hits[str(i)][1] = hits[str(i)][1] + [10 ** 6]
    assert bt.scan_parity(res, lengths, got, sample).startswith(
        "read %d" % i)


def test_device_scan_section_on_the_cpu(
        panel, tmp_path, native_cli, front_end_env):  # noqa: F811
    """The section with its host scanner run as a program and the
    -s2 host run."""
    from types import SimpleNamespace
    fasta, db = panel
    reads = str(tmp_path / "r.fq")
    bt.gen_se(fasta, reads, 200)
    row = bt.scan_section(torch, CPU, {"sample": 25},
                          SimpleNamespace(db=db, reads=reads), front_end_env)
    assert row["device_host_parity"] is True and row["sample"] == 25
    assert row["n"] == 200 and row["host_s2_wall_s"] > 0
    assert "reads_per_sec_chip" not in row and row["not_measured"]


def test_whole_program_on_the_cpu(native_cli, tmp_path):  # noqa: F811
    """bench_torch.py --device cpu at a tiny scale: every row at parity,
    the dense requests of the -1t1 rows and the nw_qext requests of the
    ONT pre-pass seen, mh_scaling not ported, no jax or kma_tpu module in
    the program."""
    out = tmp_path / "bench.json"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("KMA_DEVSERVE_DIR", None)
    r = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu",
                        "--scale", "0.005", "--out", str(out)],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "cpu (no card)"
    last = json.loads(lines[-1])
    assert last == json.loads(out.read_text())
    c = last["configs"]
    assert set(c) == set(bt.E2E) | {"mh_scaling", "nw_kernel",
                                    "device_scan", "device_e2e"}
    for name in bt.E2E + ("device_e2e",):
        assert c[name]["parity"] is True, name
        assert len(c[name].get("walls_s", [])) == bt.REPS, name
    assert c["device_e2e"]["nw_prepass"]["parity"] is True
    assert c["device_e2e"]["nw_prepass"]["nw_qext_auto"] > 0
    assert c["device_e2e"]["nw_prepass"]["nw_qext_off"] == 0
    for name in ("se_1t1", "full_outputs", "device_e2e"):
        assert c[name]["requests_by_op"]["dense"] > 0, name
        assert c[name]["requests"].startswith("dense "), name
    assert c["nw_kernel"]["exact"] is True
    assert c["device_scan"]["device_host_parity"] is True
    assert c["mh_scaling"] == {"not_ported": bt.MH_NOT_PORTED}
    assert last["failed"] == [] and last["forbidden_modules"] == []
    assert last["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert last["value"] == c["se_1t1"]["reads_per_sec"] > 0
    assert last["daemon"]["scanner"] == "dense"
    assert last["daemon"]["daemon_start_s"] > 0


def test_no_card_exits_1(tmp_path):
    """Without a card and without --device cpu it exits 1 with a
    message and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1
    assert "--device cpu" in r.stderr and "{" not in r.stdout


def test_bench_torch_imports_no_kma_tpu():
    """No import statement of bench_torch.py names kma_tpu or jax: it
    runs the JAX package's front end and oracles only as programs."""
    tree = ast.parse((REPO / "bench_torch.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "torch" in names and "kma_tpu_torch.ops" in names
    assert not [n for n in names if n.split(".")[0] in ("kma_tpu", "jax")]
