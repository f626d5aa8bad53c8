#!/usr/bin/env python3
"""``bench.py``'s rows with the port's device work, on one CUDA card::

    python3 bench_torch.py [--device cuda|cpu] [--scale F] [--out FILE]

Run from the root of a checkout.  It is the port's counterpart of the
JAX package's ``bench.py``: the same rows, read counts and shapes, and
the same parity rule, with the card doing what the TPU did.  It imports
``torch`` and ``kma_tpu_torch``, never ``jax`` or anything of
``kma_tpu``: the JAX package's front end (the index build, its native
libraries, ``bin/kma``, ``python -m kma_tpu`` and the two host oracles
below) runs only as programs that see a jax which refuses to import, as
in ``chip_smoke.py``, which it loads beside it by path.

Assets (under ``build/bench_torch/scale_<F>/``, made once from seeds and
reused): ``chip_smoke.py``'s synthetic panel the size of ResFinder
(2,250 templates), indexed with ``python -m kma_tpu index``; from it,
``bench.py``'s own generators ported line for line: 20,000 single-end
100 bp reads, 10,000 pairs (insert 205) and 2,000 chimeric ONT-like
reads (seed 23).  A warm daemon on the panel (``launch.start``, served
from a thread of this process on a socket under ``KMA_DEVSERVE_DIR``)
serves every ``-device on`` run; each such run gets the card's figures
(``envelope.child_env``) and ``KMA_TPU_PILEUP=off``.  The rows:

``se_1t1`` ``pe_apm`` ``ont_bcnano`` ``ont_mem`` ``ont_hmm`` ``full_outputs``
    ``bin/kma`` with ``bench.py``'s arguments (bench.py:631-675),
    ``-device on`` against the daemon and ``-device off`` on the host,
    3 runs each in turn: best, median and range of the walls, reads/s of
    both and ``vs_host``; byte parity of ``.res`` and the row's other
    artifacts (``.gz`` members decompressed, ``.mapstat`` without its
    ``## command`` and ``## date`` lines), compared before the ``-t 4``
    runs that write the same prefixes; the daemon's requests by op and
    the kernel launches the row's 4 ``-device on`` runs caused;
``mh_scaling``
    not ported: ``-mh`` runs ``kma_tpu``'s pipeline under
    jax.distributed in every process;
``nw_kernel`` (a child process)
    the CUDA NW kernel's slab entry on bench.py's problem (B 2,048
    windows of 160 x 150 at band 126, 5 % substitutions, seed 5), every
    score against the plain version and every 16th against
    ``kma_tpu.align.nw.nw_band`` (a program); cell updates/s, with host
    transfers, CUDA-event ms and share of the bound, and the qext entry
    on the same windows;
``device_scan`` (a child process)
    the port's ``DenseScanner`` on the 20,000 reads (batch 4,096), best
    of 3, against ``SaveKmersScanner`` (a program) on a 500-read sample
    and against ``bin/kma -1t1 -s2 -device off`` (which the native CLI
    hands to ``python -m kma_tpu``); the run-scoring kernel's CUDA-event
    ms at that batch beside its bound;
``device_e2e`` (in this process, which holds the daemon's counts)
    ``bin/kma -1t1 -device on`` against the daemon (first and warm
    walls) and ``-device off``, ``.res/.fsa/.aln`` and ``.frag.gz`` at
    parity; its ``nw_prepass`` sub-row, ``python -m kma_tpu`` on the ONT
    reads with ``-bcNano -bc 0.7 -device on`` unfused, the NW pre-pass
    on the host (``KMA_TPU_NW=off``) against the card (``auto``).

Child sections run under deadlines within ``KMA_BENCH_BUDGET`` seconds
(2100).  The last line of stdout (also written to ``--out``, default
``build/bench_torch/bench_torch.json``) is one JSON object with
bench.py's keys (``metric``, ``value``: ``se_1t1``'s ``-device on``
reads/s, ``vs_baseline``: the geometric mean of the six rows'
``vs_host``, ``configs``) and the card's name and power limit.  A row
that fails, loses parity, times out or is skipped stays in that line
and the exit code is 1.  Without a CUDA card it exits 1 unless
``--device cpu`` is given (a CPU daemon and the kernels' plain
versions; no device metric is measured).  ``--scale`` multiplies every
count (templates, reads, pairs, ONT reads, NW windows, the sample).
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KMA = os.path.join(HERE, "bin", "kma")
ASSETS = os.path.join(HERE, "build", "bench_torch")
N_TEMPLATES = 2250          # chip_smoke's panel, ResFinder's size
N_READS = 20000
N_PAIRS = 10000
N_ONT = 2000
READ_LEN = 100
BATCH = 4096
#: bench.py's NW problem (bench.py:447-449): windows, t_len, q_len, band
NW_B, NW_T_LEN, NW_Q_LEN, NW_BAND = 2048, 160, 150, 126
NW_REP = 16
N_SAMPLE = 500
REPS = 3
RUN_TIMEOUT = 600
BUDGET = float(os.environ.get("KMA_BENCH_BUDGET", 2100))
E2E = ("se_1t1", "pe_apm", "ont_bcnano", "ont_mem", "ont_hmm",
       "full_outputs")
#: bench.py's e2e rows (bench.py:631-675): (name, count, input, the flags
#: between -o and -t, artifacts compared beside .res)
E2E_ROWS = (
    ("se_1t1", "reads", "se", ["-1t1"], (".fsa", ".aln", ".frag.gz")),
    ("pe_apm", "pairs", "pe", ["-apm", "p"], ()),
    ("ont_bcnano", "ont", "ont", ["-bcNano", "-bc", "0.7"], ()),
    ("ont_mem", "ont", "ont", ["-mem_mode"], ()),
    ("ont_hmm", "ont", "ont", ["-hmm"], (".fsa", ".aln", ".frag.gz")),
    ("full_outputs", "reads", "se", ["-1t1", "-matrix", "-vcf", "-ef"],
     (".mat.gz", ".vcf.gz", ".mapstat", ".fsa", ".aln")),
)
MH_NOT_PORTED = (
    "-mh runs kma_tpu.pipeline.run_kma in every process and all-gathers "
    "through jax.distributed (kma_tpu/parallel/multihost.py:198-211); "
    "python -m kma_tpu_torch refuses -mh")
SERVED = "# device: using devserve session"
#: stderr lines that mean a -device on run did not stay on the daemon
LOST = ("devserve lost", "device NW pre-pass failed")
_T0 = time.monotonic()

# SaveKmersScanner on the sampled reads, as a program: argv db reads
# sample.json out.json; writes {read index: null or [rc_flag, templates]}
# and the sample's read lengths
HOST_SCAN = """
import json, sys
from kma_tpu.config import Penalties
from kma_tpu.index.format import load_index
from kma_tpu.io.pipeline import iter_reads
from kma_tpu.mapping.scan import SaveKmersScanner
db, reads, sample, out = sys.argv[1:5]
pen = Penalties()
pen.score_matrix()
host = SaveKmersScanner(load_index(db), pen)
rs = list(iter_reads([reads]))
hits, lens = {}, {}
for i in json.load(open(sample)):
    hit = host.scan(rs[i].codes, rs[i].n_positions, rs[i].header)
    hits[i] = None if hit is None else [
        int(hit.rc_flag), [int(t) for t in hit.templates]]
    lens[i] = len(rs[i].codes)
json.dump({"n": len(rs), "hits": hits, "lengths": lens}, open(out, "w"))
"""

# kma_tpu.align.nw.nw_band on windows saved by the NW section, as a
# program (bench.py:470-480): argv problem.npz; prints the scores
NW_ORACLE = """
import json, sys
import numpy as np
from kma_tpu.align.nw import nw_band
from kma_tpu.config import Penalties
p = np.load(sys.argv[1])
pen = Penalties()
d = pen.score_matrix()[:5, :5].astype(np.int8)
T, Q, band = (int(x) for x in p["shape"])
print(json.dumps([int(nw_band(t, q, -1, 0, T, 0, Q, band, d, pen.W1, pen.U,
                              pen.MM, T).score)
                  for t, q in zip(p["t"], p["q"])]))
"""


class BenchError(Exception):
    """A run or check of a row failed; the row records the message."""


def remaining() -> float:
    return BUDGET - (time.monotonic() - _T0)


def median(xs):
    xs = sorted(xs)
    return (xs[len(xs) // 2] + xs[(len(xs) - 1) // 2]) / 2


def sizes(scale: float) -> dict:
    """Every count of the run at ``scale`` (1: bench.py's)."""
    full = {"templates": N_TEMPLATES, "reads": N_READS, "pairs": N_PAIRS,
            "ont": N_ONT, "nw_b": NW_B, "sample": N_SAMPLE}
    return {k: max(1, int(round(v * scale))) for k, v in full.items()}


# -- assets: bench.py's generators (bench.py:86-174) on the panel ----------

# kma.c:1442-1481, as kma_tpu.io.seq.TO2BIT
TO2BIT = np.full(256, 8, dtype=np.uint8)
TO2BIT[ord("\n")] = 16
for _chars, _code in (
        ("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3), ("Nn", 4),
        ("Rr", 0), ("Yy", 1), ("Ss", 2), ("Ww", 3), ("Kk", 2), ("Mm", 0),
        ("Bb", 1), ("Dd", 0), ("Hh", 3), ("Vv", 2), ("Xx", 4), ("Uu", 3)):
    for _c in _chars:
        TO2BIT[ord(_c)] = _code


def _codes(chunks) -> np.ndarray:
    codes = TO2BIT[np.frombuffer(b"".join(chunks), np.uint8)]
    return codes[codes < 8]


def parse_fasta(path):
    """(header, codes) of each record of a plain FASTA file, as
    ``kma_tpu.io.seq.parse_fasta`` yields them: the header chomped,
    characters that translate to 8 dropped."""
    with open(path, "rb") as f:
        header, chunks = None, []
        for line in f:
            if line.startswith(b">"):
                if header is not None:
                    yield header, _codes(chunks)
                header, chunks = line.rstrip(b" \t\r\n\x0b\x0c"), []
            elif header is not None:
                chunks.append(line)
        if header is not None:
            yield header, _codes(chunks)


def gen_se(resf, reads, n):
    """bench.py's ``_gen_se`` with ``n`` for N_READS."""
    rng = np.random.default_rng(7)
    recs = list(parse_fasta(str(resf)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    with open(reads, "w") as f:
        i = 0
        while i < n:
            _h, codes = recs[rng.integers(len(recs))]
            if len(codes) <= READ_LEN + 1:
                continue
            s = int(rng.integers(0, len(codes) - READ_LEN))
            r = codes[s: s + READ_LEN].copy()
            ne = rng.binomial(READ_LEN, 0.01)
            pos = rng.integers(0, READ_LEN, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write("@r%d\n%s\n+\n%s\n"
                    % (i, "".join("ACGTN"[c] for c in r), "I" * READ_LEN))
            i += 1


def gen_pe(resf, r1p, r2p, n):
    """bench.py's ``_gen_pe`` with ``n`` for N_PAIRS."""
    rng = np.random.default_rng(11)
    recs = list(parse_fasta(str(resf)))
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    INS = 205
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        i = 0
        while i < n:
            _h, codes = recs[rng.integers(len(recs))]
            if len(codes) <= INS + 2:
                continue
            s = int(rng.integers(0, len(codes) - INS))
            frag = codes[s:s + INS]
            r1 = frag[:READ_LEN].copy()
            r2 = comp[frag[-READ_LEN:][::-1]].copy()
            for r in (r1, r2):
                ne = rng.binomial(READ_LEN, 0.01)
                pos = rng.integers(0, READ_LEN, ne)
                r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
            f1.write("@p%d/1\n%s\n+\n%s\n"
                     % (i, "".join("ACGTN"[c] for c in r1),
                        "I" * READ_LEN))
            f2.write("@p%d/2\n%s\n+\n%s\n"
                     % (i, "".join("ACGTN"[c] for c in r2),
                        "I" * READ_LEN))
            i += 1


def gen_ont(resf, reads, n):
    """bench.py's ``_gen_ont`` with ``n`` for N_ONT."""
    rng = np.random.default_rng(23)
    recs = [r for r in parse_fasta(str(resf)) if len(r[1]) > 320]
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    with open(reads, "w") as f:
        i = 0
        while i < n:
            parts = []
            for _ in range(int(rng.integers(1, 4))):
                _h, codes = recs[rng.integers(len(recs))]
                hi = min(1200, len(codes))
                L = int(rng.integers(300, hi)) if hi > 300 else hi
                s = int(rng.integers(0, len(codes) - L + 1))
                frag = codes[s:s + L].copy()
                if rng.random() < 0.5:
                    frag = comp[frag[::-1]]
                parts.append(frag)
            r = np.concatenate(parts)
            out = []
            for c in r:
                x = rng.random()
                if x < 0.02:
                    out.append((c + rng.integers(1, 4)) % 4)
                elif x < 0.035:
                    out.append(c)
                    out.append(rng.integers(0, 4))
                elif x < 0.05:
                    pass
                else:
                    out.append(c)
            r = np.array(out, np.uint8)
            if len(r) < 100:
                continue
            f.write("@n%d\n%s\n+\n%s\n"
                    % (i, "".join("ACGTN"[c] for c in r), "I" * len(r)))
            i += 1


def asset_paths(scale: float) -> SimpleNamespace:
    d = os.path.join(ASSETS, "scale_%g" % scale)
    j = lambda name: os.path.join(d, name)  # noqa: E731
    return SimpleNamespace(dir=d, fasta=j("panel.fsa"), db=j("panel"),
                           reads=j("reads.fq"), pe1=j("pe_1.fq"),
                           pe2=j("pe_2.fq"), ont=j("ont.fq"),
                           stamp=j("assets.json"))


def ensure_assets(smoke, env, scale: float) -> SimpleNamespace:
    """The panel, its index and the reads at ``scale``, made unless the
    stamp of an earlier run at the same counts is there."""
    a = asset_paths(scale)
    sz = sizes(scale)
    if os.path.isfile(a.stamp):
        with open(a.stamp) as f:
            if json.load(f) == sz:
                return a
    os.makedirs(a.dir, exist_ok=True)
    t0 = time.perf_counter()
    smoke.make_panel(a.fasta, np, sz["templates"])
    smoke.index_db([sys.executable, "-m", "kma_tpu"], env, a.fasta, a.db,
                   os.path.join(a.dir, "index.log"))
    gen_se(a.fasta, a.reads, sz["reads"])
    gen_pe(a.fasta, a.pe1, a.pe2, sz["pairs"])
    gen_ont(a.fasta, a.ont, sz["ont"])
    with open(a.stamp, "w") as f:
        json.dump(sz, f)
    print("# assets: %s made in %.1f s" % (sz, time.perf_counter() - t0),
          file=sys.stderr, flush=True)
    return a


def read_codes(path):
    """Codes [N, max length] uint8 (4 past a read's end) and lengths of a
    FASTQ file's reads, untrimmed (every quality is 'I')."""
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    lengths = np.array([len(s) for s in seqs], np.int32)
    codes = np.full((len(seqs), int(lengths.max())), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = TO2BIT[np.frombuffer(s, np.uint8)]
    return codes, lengths


# -- parity ----------------------------------------------------------------

MAPSTAT_MASK = (b"## command", b"## date")


def _artifact(path, ext):
    if ext.endswith(".gz"):
        with gzip.open(path) as f:
            return f.read()
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".mapstat":
        return [ln for ln in data.splitlines()
                if not ln.startswith(MAPSTAT_MASK)]
    return data


def mismatch(a, b, exts):
    """The first of ``exts`` whose artifact differs between prefixes
    ``a`` and ``b`` (bench.py:244-263: ``.gz`` members decompressed,
    ``.mapstat`` without its command and date lines), or None."""
    for ext in exts:
        try:
            if _artifact(a + ext, ext) != _artifact(b + ext, ext):
                return ext
        except OSError as e:
            return "%s (%s)" % (ext, e.strerror)
    return None


def apply_parity(row, differs, rates):
    """Record the parity of ``row``; a mismatch zeroes its ``rates``
    (bench.py:264-268)."""
    row["parity"] = differs is None
    if differs is not None:
        row["mismatch"] = differs
        for k in rates:
            row[k] = 0.0
        print("# PARITY FAILURE: %s differs" % differs, file=sys.stderr)


def failures(configs) -> list:
    """The rows that failed, lost parity or exactness, or were skipped."""
    bad = []
    for name, row in configs.items():
        if name == "mh_scaling":
            continue
        subs = [row] + [v for v in row.values() if isinstance(v, dict)
                        and ("parity" in v or "error" in v)]
        if any("error" in r or "skipped" in r or r.get("parity") is False
               or r.get("exact") is False
               or r.get("device_host_parity") is False for r in subs):
            bad.append(name)
    return bad


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m in ("jax", "kma_tpu")
                  or m.startswith(("jax.", "kma_tpu.")))


# -- runs ------------------------------------------------------------------

def run(cmd, env, what, timeout=RUN_TIMEOUT):
    """(wall, stderr) of one run of ``cmd``; BenchError unless it exits 0
    within ``timeout`` (capped by the budget left)."""
    timeout = min(timeout, max(30.0, remaining() - 60))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        raise BenchError("%s: no end within %d s" % (what, timeout))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise BenchError("%s exited %d: %s" % (what, r.returncode,
                                               r.stderr[-1500:]))
    return wall, r.stderr


def walls(prefix, ws) -> dict:
    return {prefix + "wall_s": min(ws), prefix + "wall_median_s": median(ws),
            prefix + "wall_range_s": [min(ws), max(ws)],
            prefix + "walls_s": ws}


class Bench:
    """What the parent's rows share: the assets, the daemon, the
    environments of host and served runs, and the work directory."""

    def __init__(self, assets, sz, srv, env_off, env_on, work):
        self.a, self.sz, self.srv = assets, sz, srv
        self.env_off, self.env_on, self.work = env_off, env_on, work

    def o(self, name):
        return os.path.join(self.work, name)

    def on(self, cmd, what, env=None):
        """A ``-device on`` run: it must reach the daemon and stay on it,
        and the daemon must not fault."""
        n0 = sum(self.srv.faults.values())
        wall, err = run(cmd, env or self.env_on, what + " -device on")
        if SERVED not in err:
            raise BenchError("%s -device on: no devserve session" % what)
        for bad in LOST:
            if bad in err:
                raise BenchError("%s -device on: stderr reports %r"
                                 % (what, bad))
        if sum(self.srv.faults.values()) != n0:
            raise BenchError("%s -device on: the daemon %s"
                             % (what, self.srv.fault_line()))
        return wall

    def off(self, cmd, what):
        return run(cmd, self.env_off, what + " -device off")[0]

    def snapshot(self):
        from kma_tpu_torch.devserve import kernel_launches
        g = self.srv.graphs
        return (collections.Counter(self.srv.requests), kernel_launches(),
                collections.Counter(self.srv.faults),
                None if g is None else collections.Counter(g.replays))

    def served_since(self, snap) -> dict:
        """The daemon's requests by op, its step graphs' replays, its
        faults and the kernel launches since ``snap``, the requests,
        graphs and faults also as ``launch.request_line`` words."""
        from kma_tpu_torch import launch
        from kma_tpu_torch.devserve import kernel_launches
        req = collections.Counter(self.srv.requests) - snap[0]
        now = kernel_launches()
        g = self.srv.graphs
        return {"requests": launch.request_line(SimpleNamespace(
                    requests=req, device=self.srv.device,
                    faults=collections.Counter(self.srv.faults) - snap[2],
                    first_fault=self.srv.first_fault,
                    graphs=None if g is None else SimpleNamespace(
                        captures=g.captures,
                        replays=collections.Counter(g.replays) - snap[3]))),
                "requests_by_op": dict(req),
                "launches": {k: now[k] - snap[1][k] for k in now}}


def e2e_row(b, name, count, inp, flags, extra):
    """One e2e row (bench.py:225-277) with ``-device on`` against the
    daemon in the place of the reference binary."""
    n = b.sz[count]
    inputs = {"se": ["-i", b.a.reads], "pe": ["-ipe", b.a.pe1, b.a.pe2],
              "ont": ["-i", b.a.ont]}[inp]

    def cmd(route, threads="1"):
        return ([KMA] + inputs + ["-t_db", b.a.db, "-o",
                                  b.o("%s_%s" % (name, route))]
                + flags + ["-t", threads, "-device", route])

    ws = {"on": [], "off": []}
    snap = b.snapshot()
    for _ in range(REPS):
        ws["on"].append(b.on(cmd("on"), name))
        ws["off"].append(b.off(cmd("off"), name))
    row = dict({"n": n}, **walls("", ws["on"]), **walls("host_", ws["off"]))
    row["reads_per_sec"] = n / min(ws["on"])
    row["host_reads_per_sec"] = n / min(ws["off"])
    row["vs_host"] = min(ws["off"]) / min(ws["on"])
    # compared now, before the -t 4 runs write the same prefixes
    apply_parity(row, mismatch(b.o(name + "_on"), b.o(name + "_off"),
                               (".res",) + tuple(extra)),
                 ("reads_per_sec", "vs_host"))
    row["wall_t4_s"] = b.on(cmd("on", "4"), name + " -t 4")
    row["host_wall_t4_s"] = b.off(cmd("off", "4"), name + " -t 4")
    row.update(b.served_since(snap))
    return row


def nw_prepass(b):
    """bench.py:579-608: the ONT reads through the Python CLI, unfused,
    ``-device on``, the NW pre-pass on the host (``KMA_TPU_NW=off``)
    against the card (``auto``, the ``nw_qext`` op)."""
    nw = {}
    for mode in ("off", "auto"):
        env = dict(b.env_on, KMA_TPU_NO_FUSED="1", KMA_TPU_NW=mode)
        cmd = [sys.executable, "-m", "kma_tpu", "-i", b.a.ont, "-t_db",
               b.a.db, "-o", b.o("bnw_" + mode), "-bcNano", "-bc", "0.7",
               "-t", "1", "-device", "on"]
        snap = b.snapshot()
        ws = [b.on(cmd, "nw_prepass KMA_TPU_NW=" + mode, env)
              for _ in range(REPS)]
        nw["wall_%s_s" % mode] = min(ws[1:])
        nw["walls_%s_s" % mode] = ws
        s = b.served_since(snap)
        nw["requests_%s" % mode] = s["requests"]
        nw["nw_qext_%s" % mode] = s["requests_by_op"].get("nw_qext", 0)
    nw["vs_host_prepass"] = nw["wall_off_s"] / nw["wall_auto_s"]
    apply_parity(nw, mismatch(b.o("bnw_auto"), b.o("bnw_off"),
                              (".res", ".fsa")), ("vs_host_prepass",))
    return nw


def device_e2e(b):
    """bench.py:504-620: native ``-1t1 -device on`` against the warm
    daemon, first and warm walls, against ``-device off``."""
    n = b.sz["reads"]

    def cmd(route):
        return [KMA, "-i", b.a.reads, "-t_db", b.a.db, "-o",
                b.o("bdev_" + route), "-1t1", "-t", "1", "-device", route]

    on, off = [], []
    snap = b.snapshot()
    for _ in range(REPS):
        on.append(b.on(cmd("on"), "device_e2e"))
        off.append(b.off(cmd("off"), "device_e2e"))
    row = dict({"n": n, "wall_first_s": on[0], "warm_wall_s": min(on[1:]),
                "walls_s": on, "reads_per_sec_e2e": n / min(on[1:])},
               **walls("host_", off), **b.served_since(snap))
    row["vs_host"] = min(off) / min(on[1:])
    apply_parity(row, mismatch(b.o("bdev_on"), b.o("bdev_off"),
                               (".res", ".fsa", ".aln", ".frag.gz")),
                 ("reads_per_sec_e2e", "vs_host"))
    row["nw_prepass"] = nw_prepass(b)
    return row


# -- child sections --------------------------------------------------------

def on_card(dev) -> bool:
    return dev.type == "cuda"


def nw_problem(B, seed=5):
    """bench.py's NW windows (bench.py:446-461): templates [B, T_LEN]
    and queries [B, Q_LEN] uint8, queries at 5 % substitutions."""
    rng = np.random.default_rng(seed)
    ts, qs = [], []
    for _ in range(B):
        t = rng.integers(0, 4, NW_T_LEN).astype(np.uint8)
        q = t[: NW_Q_LEN].copy()
        ne = rng.binomial(NW_Q_LEN, 0.05)
        pos = rng.integers(0, NW_Q_LEN, ne)
        q[pos] = (q[pos] + rng.integers(1, 4, ne)) % 4
        ts.append(t)
        qs.append(q)
    return np.stack(ts), np.stack(qs)


def nw_operands(torch, dev, ts, qs):
    """The slab and qext entries' operands on ``dev``: the qext staging
    (``stage_qext``), its slab expanded on the device (``expand_qext``);
    kflag -1, half-band BAND // 2."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.ops import nw_kernel as nk
    pen = Penalties()
    d = pen.score_matrix()[:5, :5]
    B = len(ts)
    tl, ql, hb, qext, tcol = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in nk.stage_qext(list(ts), list(qs), [NW_T_LEN] * B,
                               [NW_Q_LEN] * B, NW_BAND))
    kf = torch.full((B,), -1, dtype=torch.int32, device=dev)
    msc = nk.expand_qext(qext, tcol, d)
    return SimpleNamespace(pen=pen, d=d, tl=tl, ql=ql, kf=kf, hb=hb,
                           qext=qext, tcol=tcol, msc=msc)


def nw_section(torch, dev, sz, env):
    """bench.py:433-501 on the port's NW kernel."""
    from kma_tpu_torch import kernel_bench as kb
    from kma_tpu_torch.ops import nw_kernel as nk
    B = sz["nw_b"]
    ts, qs = nw_problem(B)
    x = nw_operands(torch, dev, ts, qs)
    p = x.pen
    slab = (x.tl, x.ql, x.kf, x.msc, x.hb, p.W1, p.U, p.MM)
    fn = lambda: nk.nw_band_score(*slab)  # noqa: E731
    fq = lambda: nk.nw_band_score_qext(  # noqa: E731
        x.tl, x.ql, x.kf, x.hb, x.qext, x.tcol, dmat=x.d, W1=p.W1, U=p.U,
        MM=p.MM)
    l0 = (nk.nw_band_score.launches, nk.nw_band_score_codes.launches)
    out = fn().cpu()
    plain = nk.nw_band_score_plain(*slab).cpu()
    qout = fq().cpu()
    launches = {"nw_band_score": nk.nw_band_score.launches - l0[0],
                "nw_band_score_codes": nk.nw_band_score_codes.launches
                - l0[1]}
    exact_plain = bool(torch.equal(out, plain)) and bool(
        torch.equal(qout, plain))
    # the host oracle on every 16th window (bench.py:470-480)
    every = list(range(0, B, 16))
    prob = os.path.join(tempfile.mkdtemp(prefix="kma_bench_nw_"), "p.npz")
    np.savez(prob, t=ts[every], q=qs[every],
             shape=np.array([NW_T_LEN, NW_Q_LEN, NW_BAND]))
    try:
        r = subprocess.run([sys.executable, "-c", NW_ORACLE, prob], env=env,
                           capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(os.path.dirname(prob), ignore_errors=True)
    if r.returncode != 0:
        raise BenchError("the nw_band oracle exited %d: %s"
                         % (r.returncode, r.stderr[-1500:]))
    oracle = json.loads(r.stdout.strip().splitlines()[-1])
    exact_oracle = oracle == out[every].tolist()
    cells = B * NW_T_LEN * (NW_BAND + 1)
    row = {"exact": exact_plain and exact_oracle,
           "exact_plain": exact_plain, "exact_nw_band": exact_oracle,
           "oracle_windows": len(every), "batch": B, "t_len": NW_T_LEN,
           "q_len": NW_Q_LEN, "band": NW_BAND, "cells_a_call": cells,
           "launches": launches}
    if not on_card(dev):
        row["not_measured"] = "a CPU run: no device metric"
        return row
    R, L = x.msc.shape[0], x.msc.shape[2]
    bounds = kb.nw_bounds(torch, x.tl, x.ql, x.hb, B, R, L)

    def rate(f):
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            [f() for _ in range(NW_REP)]
            torch.cuda.synchronize(dev)
            best = max(best, NW_REP * cells / (time.perf_counter() - t0))
        return best

    row["cell_updates_per_sec"] = rate(fn)
    # operands copied from host numpy every call (bench.py:488-490)
    host = [t.cpu().numpy() for t in slab[:5]]

    def shipped():
        return nk.nw_band_score(*(torch.from_numpy(h).to(dev)
                                  for h in host), p.W1, p.U, p.MM)

    shipped()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    [shipped() for _ in range(2)]
    torch.cuda.synchronize(dev)
    row["with_transfers"] = 2 * cells / (time.perf_counter() - t0)
    row["ms"] = kb.cuda_ms(torch, fn, 50, rounds=5)
    row["bound_ms"], row["bound_by"] = bounds["nw_band_score"]
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["plain_ms"] = kb.cuda_ms(torch, lambda: nk.nw_band_score_plain(
        *slab), 2)
    row["qext_cell_updates_per_sec"] = rate(fq)
    row["qext_ms"] = kb.cuda_ms(torch, fq, 50, rounds=5)
    row["qext_bound_ms"], _ = bounds["nw_band_score_qext"]
    row["qext_share_of_bound"] = row["qext_bound_ms"] / row["qext_ms"]
    return row


def scan_sample(torch, dev, db, reads, n_sample):
    """The port's DenseScanner over every read, best of 3 after bench.py's
    warm-up calls (bench.py:365-392).  Returns (scanner, codes, lengths,
    (scores, modes, tid_lists, over), walls, the sample's read indices)."""
    from kma_tpu_torch.config import Penalties
    from kma_tpu_torch.index.format import load_index
    from kma_tpu_torch.mapping.scan_dense import DenseScanner
    pen = Penalties()
    pen.score_matrix()
    sc = DenseScanner(load_index(db), pen, batch=BATCH, device=dev)
    codes, lengths = read_codes(reads)
    N = len(codes)
    sc.scan_reads(codes[:BATCH], lengths[:BATCH])
    sc._rescan_wide(codes, lengths, np.array([0]), np.zeros(N, np.int32),
                    np.zeros(N, np.uint8), [None] * N, np.zeros(N, bool))
    ws = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = sc.scan_reads(codes, lengths)
        ws.append(time.perf_counter() - t0)
    sample = np.random.default_rng(3).choice(N, size=min(n_sample, N),
                                             replace=False)
    return sc, codes, lengths, res, ws, sample.tolist()


def host_scan(env, db, reads, sample):
    """SaveKmersScanner's hits on ``sample`` (the HOST_SCAN program)."""
    work = tempfile.mkdtemp(prefix="kma_bench_scan_")
    try:
        with open(os.path.join(work, "sample.json"), "w") as f:
            json.dump(sample, f)
        out = os.path.join(work, "hits.json")
        r = subprocess.run([sys.executable, "-c", HOST_SCAN, db, reads,
                            os.path.join(work, "sample.json"), out],
                           env=env, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            raise BenchError("the host scanner exited %d: %s"
                             % (r.returncode, r.stderr[-1500:]))
        with open(out) as f:
            got = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return got


def scan_parity(res, lengths, host, sample):
    """The first sampled read whose device result differs from the host
    scanner's (bench.py:394-416), as a message, or None."""
    scores, modes, tid_lists, _over = res
    if host["n"] != len(lengths):
        return "the host read %d reads, the port %d" % (host["n"],
                                                        len(lengths))
    for i in sample:
        hit = host["hits"][str(i)]
        if host["lengths"][str(i)] != int(lengths[i]):
            return "read %d: lengths %d / %d" % (
                i, host["lengths"][str(i)], lengths[i])
        dev_t = tid_lists[i]
        if hit is None:
            if int(scores[i]) > 0 and dev_t is not None and len(dev_t):
                return "read %d: the host found no hit, the device %s" % (
                    i, dev_t)
            continue
        if dev_t is None or int(scores[i]) != abs(hit[0]) \
                or np.asarray(dev_t).tolist() != hit[1]:
            return ("read %d: device score %d tids %s, host rc_flag %d "
                    "tids %s" % (i, scores[i], dev_t, hit[0], hit[1]))
    return None


def scan_section(torch, dev, sz, a, env):
    """bench.py:356-430 on the port's DenseScanner."""
    from functools import partial
    from kma_tpu_torch import kernel_bench as kb
    from kma_tpu_torch.ops import scan_kernel as sk
    l0 = sk.run_score_rows.launches
    sc, codes, lengths, res, ws, sample = scan_sample(
        torch, dev, a.db, a.reads, sz["sample"])
    N = len(codes)
    why = scan_parity(res, lengths, host_scan(env, a.db, a.reads, sample),
                      sample)
    if why:
        print("# device/host scan mismatch at %s" % why, file=sys.stderr)
    row = {"n": N, "batch": BATCH, "device_host_parity": why is None,
           "sample": len(sample),
           "residual_host_fallback": int(res[3].sum()),
           "wide_reads": sc.wide_reads,
           "launches": {"run_score_rows": sk.run_score_rows.launches - l0}}
    if why:
        row["mismatch"] = why
    # bin/kma's step 2 alone on the host, in the reference -s2 run's
    # place (bench.py:418-428)
    tmp = tempfile.mkdtemp(prefix="kma_bench_s2_")
    try:
        host = [run([KMA, "-i", a.reads, "-o", os.path.join(tmp, "s2"),
                     "-t_db", a.db, "-1t1", "-s2", "-device", "off"], env,
                    "bin/kma -1t1 -s2 -device off")[0] for _ in range(REPS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(walls("host_s2_", host))
    row["host_s2_reads_per_sec"] = N / min(host)
    if not on_card(dev):
        row["not_measured"] = "a CPU run: no device metric"
        return row
    row.update(walls("scan_", ws))
    row["reads_per_sec_chip"] = N / min(ws) if why is None else 0.0
    row["vs_host_s2"] = row["reads_per_sec_chip"] / row[
        "host_s2_reads_per_sec"]
    # the run-scoring kernel at the scanner's first batch
    p, run_row, args = _smoke().strand_runs(
        torch, np, SimpleNamespace(didx=sc.didx, scanners={0: sc}),
        codes[:BATCH], lengths[:BATCH])
    bits = sc.didx.bits
    kern = partial(sk.run_score_rows, bits, run_row, *args, p=p)
    plain = partial(sk.run_score_rows_plain, bits, run_row, *args, p=p)
    row["kernel_exact"] = all(bool(torch.equal(u, v))
                              for u, v in zip(kern(), plain()))
    row["exact"] = row["kernel_exact"]
    row["kernel_ms"] = kb.cuda_ms(torch, kern, 50, rounds=5)
    bms, by, hits = kb.run_score_bound(torch, bits, run_row, args[3],
                                       sc.didx.t_pad, False)
    G, R = run_row.shape
    row.update(kernel_shape="G=%d R=%d T=%d" % (G, R, sc.didx.t_pad),
               kernel_bound_ms=bms, kernel_bound_by=by, kernel_hits=hits,
               kernel_share_of_bound=bms / row["kernel_ms"])
    return row


def _smoke():
    """``chip_smoke.py`` of this checkout, loaded by path (once)."""
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return mod


def section_main(name, device, scale) -> int:
    """A child's section: prints ONE JSON row on stdout."""
    import torch
    dev = torch.device(device)
    work = tempfile.mkdtemp(prefix="kma_bench_%s_" % name)
    try:
        env = _smoke().front_end_env(work)
        sz = sizes(scale)
        if on_card(dev):
            torch.zeros(1, device=dev)      # the context, for the stats
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            if name == "nw_kernel":
                row = nw_section(torch, dev, sz, env)
            elif name == "device_scan":
                row = scan_section(torch, dev, sz, asset_paths(scale), env)
            else:
                row = {"error": "unknown section %r" % name}
        except BenchError as e:
            row = {"error": str(e)}
        if on_card(dev):
            row["max_memory_allocated_mb"] = \
                torch.cuda.max_memory_allocated(dev) / 2 ** 20
        bad = forbidden_modules()
        if bad:
            row["error"] = "the section imported %s" % ", ".join(bad[:5])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(row), flush=True)
    return 0


def section_subprocess(name, cap, device, scale) -> dict:
    """``bench_torch.py --section name`` under a deadline (bench.py:54-74);
    its stderr is passed on.  Never raises."""
    cap = min(cap, max(30.0, remaining() - 120))
    if cap < 60:
        return {"skipped": "budget exhausted (%d s left)" % remaining()}
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--section", name, "--device", device,
                            "--scale", repr(scale)], capture_output=True,
                           text=True, timeout=cap)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) \
            else e.stderr or ""
        sys.stderr.write(err)
        return {"skipped": "section deadline (%d s)" % cap}
    sys.stderr.write(r.stderr)
    row = {"error": "no row (rc=%s): %s" % (r.returncode, r.stderr[-300:])}
    for line in reversed(r.stdout.splitlines()):
        if line.strip().startswith("{"):
            try:
                row = json.loads(line)
                break
            except json.JSONDecodeError:
                pass
    row["seconds"] = time.perf_counter() - t0
    print("# %s: %s" % (name, json.dumps(row)), file=sys.stderr, flush=True)
    return row


# -- the parent ------------------------------------------------------------

def result(configs, loaded, **extra):
    """(the last line, the exit code): bench.py's keys over ``configs``,
    then ``extra``, the failed rows and ``loaded``, the forbidden modules
    in ``sys.modules``; the code is 1 when either is not empty."""
    ratios = [configs.get(c, {}).get("vs_host", 0.0) for c in E2E]
    geo = float(np.exp(np.mean(np.log(ratios)))) if all(ratios) else 0.0
    bad = failures(configs)
    out = dict({
        "metric": "e2e_mapping_reads_per_sec",
        "value": configs.get("se_1t1", {}).get("reads_per_sec", 0.0),
        "unit": "reads/s e2e (SE -1t1 -device on vs the synthetic "
                "ResFinder-sized panel, -t 1, byte parity with -device "
                "off; vs_baseline = geomean speedup over -device off "
                "over the 6 e2e rows)",
        "vs_baseline": geo,
        "configs": configs}, **extra)
    out.update(failed=bad, forbidden_modules=loaded)
    return out, 1 if bad or loaded else 0


def card_line(torch, dev) -> str:
    if not on_card(dev):
        return "cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def parse_start(err) -> dict:
    """``launch.start``'s split of the daemon's start, in seconds."""
    m = re.search(r"daemon start ([0-9.]+) s \((.*)\)", err)
    if not m:
        return {}
    split = dict(part.rsplit(" ", 1) for part in m.group(2).split(", "))
    return {"daemon_start_s": float(m.group(1)),
            "split_s": {k: float(v) for k, v in split.items()}}


def row_step(configs, name, fn):
    """``configs[name] = fn()``, or the error that stopped it; with the
    row's seconds."""
    t0 = time.perf_counter()
    if remaining() < 60:
        row = {"skipped": "budget exhausted (%d s left)" % remaining()}
    else:
        try:
            row = fn()
        except (BenchError, SystemExit) as e:
            row = {"error": str(e)}
        except Exception as e:  # noqa: BLE001 -- recorded, next row
            traceback.print_exc()
            row = {"error": repr(e)}
    row["seconds"] = time.perf_counter() - t0
    configs[name] = row
    print("# %s: %s" % (name, json.dumps(row)), file=sys.stderr, flush=True)


def parse_args(argv):
    opts = {"--device": "cuda", "--scale": "1", "--section": None,
            "--out": os.path.join(ASSETS, "bench_torch.json")}
    i = 0
    while i < len(argv):
        if argv[i] not in opts or i + 1 >= len(argv):
            print(__doc__, file=sys.stderr)
            raise SystemExit(2)
        opts[argv[i]] = argv[i + 1]
        i += 2
    if opts["--device"] not in ("cuda", "cpu"):
        print("bench_torch: --device is cuda or cpu", file=sys.stderr)
        raise SystemExit(2)
    return opts


def main(argv) -> int:
    opts = parse_args(argv)
    scale = float(opts["--scale"])
    t_import = time.perf_counter()
    import torch
    if opts["--device"] == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is "
              "False); --device cpu runs it on the CPU", file=sys.stderr)
        return 1
    device = "cuda:0" if opts["--device"] == "cuda" else "cpu"
    if opts["--section"]:
        return section_main(opts["--section"], device, scale)
    from kma_tpu_torch import envelope, launch
    from kma_tpu_torch.devserve import socket_path
    setup_s = time.perf_counter() - t_import
    dev = torch.device(device)
    card = card_line(torch, dev)
    print(card, flush=True)
    smoke = _smoke()
    sz = sizes(scale)
    configs, daemon = {}, {}
    work = tempfile.mkdtemp(prefix="kma_bench_torch_")
    try:
        env_off = smoke.front_end_env(work)
        env_on = dict(env_off, **envelope.child_env(env_off))
        env_on.setdefault("KMA_TPU_PILEUP", "off")
        nat = subprocess.Popen([sys.executable, "-c", smoke.BUILD_NATIVE],
                               env=env_off, cwd=HERE, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        a = ensure_assets(smoke, env_off, scale)
        if not smoke.wait_native(nat):
            smoke.fail("native/kma_cli did not build")
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            srv = launch.start(a.db, device=device, setup_s=setup_s)
        sys.stderr.write(buf.getvalue())
        daemon = dict(parse_start(buf.getvalue()), device=str(srv.device),
                      scanner=srv.scanner_kind)
        th = smoke.serve_thread(srv, socket_path(a.db), "bench daemon")
        try:
            b = Bench(a, sz, srv, env_off, env_on, work)
            for name, count, inp, flags, extra in E2E_ROWS:
                row_step(configs, name, lambda: e2e_row(
                    b, name, count, inp, flags, extra))
            configs["mh_scaling"] = {"not_ported": MH_NOT_PORTED}
            configs["nw_kernel"] = section_subprocess("nw_kernel", 420,
                                                      opts["--device"],
                                                      scale)
            configs["device_scan"] = section_subprocess(
                "device_scan", 600, opts["--device"], scale)
            row_step(configs, "device_e2e", lambda: device_e2e(b))
        finally:
            smoke.stop_daemon(a.db, th, "bench daemon", srv)
            if on_card(dev):
                daemon["max_memory_allocated_mb"] = \
                    torch.cuda.max_memory_allocated(dev) / 2 ** 20
    except (BenchError, SystemExit) as e:
        configs.setdefault("assets_or_daemon", {"error": str(e)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out, rc = result(configs, forbidden_modules(), daemon=daemon, sizes=sz,
                     card=card, device={
                         "platform": "gpu" if on_card(dev) else "cpu",
                         "kind": torch.cuda.get_device_name(0)
                         if on_card(dev) else "cpu",
                         "count": torch.cuda.device_count()
                         if on_card(dev) else 0},
                     seconds=time.monotonic() - _T0, budget_s=BUDGET)
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(opts["--out"])),
                exist_ok=True)
    with open(opts["--out"], "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
