"""Sample traffic: closed-loop clients, each running the native CLI
(``native/kma_cli``) on one sample after another against the daemon, as
a lab maps its isolates' read files against one panel.

The mix gives ``clients``, ``reads_per_sample`` and the reads
(``isolate``, ``isolate.py``: an isolate's genome with a few of the
DB's templates in it); a pool of ``pool_samples`` gzipped FASTQ files,
each of its own isolate, is made from the seed and run in turn, with
the configuration's ``kma_flags``, the card's figures
(``kma_tpu_torch.envelope.child_env``), ``KMA_TPU_PILEUP=off`` and
``KMA_RUN_PROF=1``.  A run that exits 113 (the native CLI handing the
flags to the Python CLI), prints ``devserve lost``, or exits non-zero
fails the benchmark run.  End-to-end metric: ``reads_per_s`` (the reads
of every sample finished, over the window up to the last exit).
Checks: the dense answers the daemon gave (a sample of each request's
reads, recorded where the scanner resolves them) against the reference;
every gene of each sample reported in its ``.res``; and the ``.res``
and ``.fsa`` of every run of ``WITNESS_SAMPLES`` pool samples drawn from
the seed byte-equal to the native CLI's own host run of that sample
(``-device off``, after the window), which no part of the port's
device path touches.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from .. import isolate
from .common import compare_dense, db_arrays, in_flight, penalties

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: pool samples whose served outputs are held against the host run's
WITNESS_SAMPLES = 2


def fastq_gz(path: str, reads: np.ndarray, tag: str) -> None:
    """Write ``reads`` as gzipped FASTQ, names ``@<tag>_<i>``."""
    n, L = reads.shape
    names = np.array([("@%s_%09d\n" % (tag, i)).encode() for i in range(n)])
    w = len(names[0])
    rec = np.empty((n, w + 2 * L + 4), np.uint8)
    rec[:, :w] = np.frombuffer(b"".join(names), np.uint8).reshape(n, w)
    rec[:, w: w + L] = ACGT[reads]
    rec[:, w + L: w + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + L + 3: w + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(gzip.compress(rec.tobytes(), compresslevel=1))


class Recorder:
    """A sample of the dense answers the daemon's scanners resolve:
    ``per_request`` reads drawn from the seed out of every request, and
    as many out of its mapped reads."""

    def __init__(self, seed: int, per_request: int):
        self.seed, self.m = seed, per_request
        self.lock = threading.Lock()
        self.pending: Dict[int, tuple] = {}
        self.answers: List = []
        self.n = 0
        self.on = False

    def install(self, srv) -> None:
        for sc in srv.scanners.values():
            self._wrap(sc)

    def _wrap(self, sc) -> None:
        dispatch, resolve = sc.scan_dispatch, sc.scan_resolve

        def scan_dispatch(codes, lengths):
            h = dispatch(codes, lengths)
            if self.on:
                with self.lock:
                    self.pending[id(h)] = (codes, lengths)
            return h

        def scan_resolve(h):
            out = resolve(h)
            with self.lock:
                req = self.pending.pop(id(h), None)
                if req is not None:
                    self._take(req, out)
            return out

        sc.scan_dispatch, sc.scan_resolve = scan_dispatch, scan_resolve

    def _take(self, req, out) -> None:
        codes, lengths = req
        scores, modes, tids, over = out
        rng = np.random.default_rng([self.seed, 1 << 21, self.n])
        self.n += 1
        N = len(scores)
        pick = set(rng.choice(N, min(self.m, N), replace=False).tolist())
        mapped = np.flatnonzero(np.asarray(modes) != 0)
        if len(mapped):
            pick |= set(rng.choice(mapped, min(self.m, len(mapped)),
                                   replace=False).tolist())
        for i in sorted(pick):
            n = int(lengths[i])
            self.answers.append((np.array(codes[i, :n]), n, (
                int(scores[i]), int(modes[i]), bool(over[i]),
                () if tids[i] is None else tuple(tids[i].tolist()))))


class Load:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.runs: List[Dict] = []
        self.procs: List = []
        self.rec = Recorder(ctx.seed, ctx.mix["check_reads_per_request"])

    def prepare(self) -> None:
        c, mix = self.ctx, self.ctx.mix
        codes, offsets, groups = db_arrays(c.db)
        with open(c.db["prefix"] + ".name", "rb") as f:
            self.names = f.read().split()
        self.sdir = os.path.join(c.work, "samples")
        self.odir = os.path.join(c.work, "out")
        os.makedirs(self.sdir)
        os.makedirs(self.odir)

        def one(i):
            r, genes = isolate.reads(
                codes, offsets, groups, mix["isolate"],
                mix["reads_per_sample"], np.random.default_rng([c.seed, i]))
            path = os.path.join(self.sdir, "s%d.fastq.gz" % i)
            fastq_gz(path, r, "s%d" % i)
            return path, [self.names[g] for g in genes.tolist()]

        with ThreadPoolExecutor(4) as ex:
            self.pool = list(ex.map(one, range(mix["pool_samples"])))
        from kma_tpu_torch import envelope
        from kma_tpu_torch.native_build import CLI_BIN
        self.env = dict(os.environ, **envelope.child_env(os.environ),
                        KMA_TPU_PILEUP="off", KMA_RUN_PROF="1",
                        KMA_DEVSERVE_SOCKET=c.sock)
        self.cli = CLI_BIN

    def _run(self, client: int, seq: int) -> Dict:
        c = self.ctx
        pid = (client + seq * c.mix["clients"]) % len(self.pool)
        fq, genes = self.pool[pid]
        out = os.path.join(self.odir, "c%d_%d" % (client, seq))
        t0 = time.perf_counter()
        p = subprocess.Popen([self.cli, "-i", fq, "-t_db", c.db["prefix"],
                              "-o", out] + c.cfg["kma_flags"],
                             env=self.env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
        self.procs.append(p)
        _, err = p.communicate()
        t1 = time.perf_counter()
        if p.returncode == 113:
            raise RuntimeError("native/kma_cli handed %s to the Python CLI "
                               "(exit 113)" % c.cfg["kma_flags"])
        if p.returncode != 0:
            raise RuntimeError("native/kma_cli exited %d:\n%s"
                               % (p.returncode, err[-2000:]))
        if "devserve lost" in err or "using devserve" not in err:
            raise RuntimeError("the sample run lost the daemon:\n%s"
                               % err[-2000:])
        return {"client": client, "seq": seq, "pid": pid, "t0": t0,
                "t1": t1, "reads": c.mix["reads_per_sample"], "out": out,
                "genes": genes, "prof": [ln for ln in err.splitlines()
                                         if "prof:" in ln]}

    def _clients(self, until: float, first: bool) -> List[Dict]:
        C = self.ctx.mix["clients"]
        runs, errors = [], []

        def client(i):
            seq = 0
            try:
                while first or time.perf_counter() < until:
                    runs.append(self._run(i, seq))
                    seq += 1
                    if first:
                        return
            except Exception as e:      # noqa: BLE001 - re-raised below
                errors.append(e)

        ths = [threading.Thread(target=client, args=(i,)) for i in range(C)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        if errors:
            raise errors[0]
        return runs

    def warm(self, srv) -> None:
        """One sample a client: every shape the window sends, the index
        files in the page cache."""
        self._clients(0.0, first=True)
        self.rec.install(srv)

    def window(self, t0: float, t1: float) -> List[Dict]:
        self.rec.on = True
        self.runs = self._clients(t1, first=False)
        self.rec.on = False
        self.attempted = len(self.runs)
        return self.runs

    def end_to_end(self, name: str, res):
        if name == "reads_per_s":
            return sum(x["reads"] for x in self.runs) / res.window_s
        return None

    def _host_run(self, pid: int) -> str:
        """The native CLI's host run (``-device off``) of pool sample
        ``pid``: its output prefix."""
        c = self.ctx
        flags = list(c.cfg["kma_flags"])
        flags[flags.index("-device") + 1] = "off"
        out = os.path.join(self.odir, "host%d" % pid)
        p = subprocess.run([self.cli, "-i", self.pool[pid][0], "-t_db",
                            c.db["prefix"], "-o", out] + flags,
                           env=self.env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
        if p.returncode != 0:
            raise RuntimeError("native/kma_cli -device off exited %d:\n%s"
                               % (p.returncode, p.stderr[-2000:]))
        return out

    def witness(self) -> Dict[str, int]:
        """Hold the served ``.res`` and ``.fsa`` of every run of the
        witnessed pool samples against the host run's bytes:
        {"compared": outputs, "differing": outputs}."""
        served = sorted({r["pid"] for r in self.runs})
        rng = np.random.default_rng([self.ctx.seed, 1 << 22])
        pick = rng.choice(served, min(WITNESS_SAMPLES, len(served)),
                          replace=False).tolist()
        with ThreadPoolExecutor(max(1, len(pick))) as ex:
            host = dict(zip(pick, ex.map(self._host_run, pick)))
        compared = differing = 0
        for run in self.runs:
            if run["pid"] not in host:
                continue
            for ext in (".res", ".fsa"):
                with open(run["out"] + ext, "rb") as f, \
                        open(host[run["pid"]] + ext, "rb") as g:
                    differing += f.read() != g.read()
                compared += 1
        return {"compared": compared, "differing": differing}

    def check(self) -> List[Dict]:
        from .. import reference
        c = self.ctx
        w = self.witness()
        codes, offsets, _ = db_arrays(c.db)
        kmap = reference.KmerMap(codes, offsets, device=c.device)
        r = compare_dense(kmap, self.rec.answers, penalties(c.cfg))
        missed = 0
        for run in self.runs:
            with open(run["out"] + ".res", "rb") as f:
                found = {ln.split(b"\t")[0].strip()
                         for ln in f.read().splitlines()[1:]}
            missed += sum(g not in found for g in run["genes"])
        return [
            {"name": "wrong_answers", "value": r["wrong"], "limit": 0},
            {"name": "unchecked_requests",
             "value": 0 if r["checked"] else 1, "limit": 0},
            {"name": "genes_missed", "value": missed, "limit": 0},
            {"name": "outputs_differing", "value": w["differing"],
             "limit": 0},
            {"name": "outputs_unwitnessed",
             "value": 0 if w["compared"] else 1, "limit": 0}]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def label(self, t: float) -> str:
        return in_flight(self.runs, t, self.ctx.mix["clients"],
                         "in a sample run")
