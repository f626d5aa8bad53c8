"""Wire traffic: closed-loop clients of the daemon's ``dense`` op, as
concurrent KMA ``-1t1`` runs put it on one card.

The mix gives ``clients``, ``reads_per_request``, ``depth`` (the
requests a client keeps ahead of the reply it reads, as the native
CLI's client pipelines them) and the reads (``isolate``,
``isolate.py``); a pool of ``pool_requests`` requests, each of one
isolate, is made from the seed and sent in turn.  The load runs in a
process of its own (``wire_client.py``), so the clients' host work does
not share the daemon's interpreter.  End-to-end metric:
``scan_reads_per_s`` (the reads of every reply received, over the
window up to the last reply).  Each request's span (the start of its
send to its reply fully received) labels the trace's idle gaps.  Checks: the sampled
reads against the reference (``check_reads_per_request`` a request)
and every reply to a repeated request equal to its first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np

from .common import compare_dense, db_arrays, in_flight, penalties


class Load:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = 0
        self.proc = None
        self.rec: Dict = {}
        self.pool_work = None

    def _line(self, want: str) -> str:
        line = self.proc.stdout.readline().strip()
        if not line.startswith(want):
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError("the load process said %r, not %r"
                               % (line, want))
        return line

    def prepare(self) -> None:
        c = self.ctx
        self.pool_path = os.path.join(c.work, "pool.npy")
        self.out_path = os.path.join(c.work, "load.json")
        params = dict(mix=c.mix, seed=c.seed, codes=c.db["codes"],
                      offsets=c.db["offsets"], groups=c.db["groups"],
                      pool=self.pool_path, out=self.out_path,
                      db=c.db["prefix"], sock=c.sock,
                      penalties=vars(penalties(c.cfg)))
        path = os.path.join(c.work, "load_params.json")
        with open(path, "w") as f:
            json.dump(params, f)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "wire_client.py"), path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self._line("ready")

    def warm(self, srv) -> None:
        self.proc.stdin.write("warm\n")
        self.proc.stdin.flush()
        self._line("warmed")

    def window(self, t0: float, t1: float) -> List[Dict]:
        self.proc.stdin.write("go %r %r\n" % (t0, t1))
        self.proc.stdin.flush()
        self._line("done")
        if self.proc.wait(timeout=120) != 0:
            raise RuntimeError("the load process exited %d"
                               % self.proc.returncode)
        with open(self.out_path) as f:
            self.rec = json.load(f)
        if self.rec["errors"]:
            raise RuntimeError("requests failed: %s" % self.rec["errors"])
        self.attempted = len(self.rec["units"])
        return self.rec["units"]

    def end_to_end(self, name: str, res):
        u = self.rec["units"]
        if name == "scan_reads_per_s":
            return sum(x["reads"] for x in u) / res.window_s
        return None

    def check(self) -> List[Dict]:
        from .. import reference
        c = self.ctx
        codes, offsets, _ = db_arrays(c.db)
        kmap = reference.KmerMap(codes, offsets, device=c.device)
        pool = np.load(self.pool_path)
        L = pool.shape[2]
        ans = [(pool[pid, i], L, (s, m, o, t))
               for pid, i, s, m, o, t in self.rec["checked"]]
        r = compare_dense(kmap, ans, penalties(c.cfg))
        if c.trace:
            lens = np.full(pool.shape[1], L, np.int64)
            self.pool_work = [reference.run_work(kmap, p, lens)
                              for p in pool]
        self.templates = len(offsets) - 1
        return [
            {"name": "wrong_answers", "value": r["wrong"], "limit": 0},
            {"name": "unchecked_requests",
             "value": 0 if r["checked"] and self.attempted else 1,
             "limit": 0},
            {"name": "replies_differing", "value": self.rec["differ"],
             "limit": 0}]

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def label(self, t: float) -> str:
        return in_flight(self.rec["units"], t, self.ctx.mix["clients"],
                         "with requests in flight")
