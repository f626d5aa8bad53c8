#!/usr/bin/env python3
"""The daemon's ``dense`` op of two checkouts of kma_tpu_torch on one
card, on the gene panel and the cgMLST-shaped scheme of
``chip_smoke.py``, the scheme twice: on the dense scanner and, under
``KMA_TPU_DENSE_BUDGET_MB=0``, on the pair-stream scanner (the image of a
DB past the card's dense budget), so that versions compare inside one
call (parent, change, change, parent)::

    python3 dense_ab.py --tree A_DIR --tree B_DIR [--order ABBA]
                        [--passes 5] [--out FILE]

It builds the data once (``chip_smoke.py`` beside it, loaded by path:
the panel of 2,250 templates and its 20,000 100 bp reads; the scheme of
3,002 loci x 40 alleles and 50,000 150 bp reads, indexed by ``python -m
kma_tpu index`` run as a program), then for every tree in the order
given and each DB runs one child process whose ``kma_tpu_torch`` is that
tree's (the pair-stream DB's child gets the budget of 0 in its
environment).  The child builds a ``TorchDevServer`` on the card (batch
2,048), warms it at the DB's read pad (L 128 or 192) and drives the
dense op as the native client does on the card: requests of 16,384 reads
(``KMA_DEVSLICE``), each dispatched before the previous one resolves
(the daemon's pipelined path, ``_dense_dispatch`` and ``_dense_pack``).
``--passes`` passes over the reads give the op's ms a request as the
daemon records it (``dense_ms``: dispatch plus resolve, host clock);
one more pass runs under torch.profiler for the device busy share (the
union of device events' intervals over the pass's wall) and the device
events a request.  Each child prints one JSON line: the card's name and
power limit, the DB's shape (the dense image's V, t_pad and footprint;
the pair-stream image's layout and max_probe), the scanner, the ms
(median, min, max, every sample), the busy share, peak device memory
allocated and reserved over the passes, the kernel launches, the
scanners' tier-0 batches, whole-batch retries, wide reads and wide
chunks over the passes and, where the tree's daemon has step graphs,
their keys, capture seconds, replays, evictions and pool bytes.  The
lines also go to ``--out`` (JSON lines, default
``build/dense_ab.jsonl``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: reads a request (the card's KMA_DEVSLICE, kma_tpu_torch/envelope.py)
SLICE = 16384
#: the cells whose daemon is held under a dense budget of 0, so that it
#: serves the DB with the pair-stream scanner
PAIR_STREAM = ("cgmlst_pair_stream",)

CHILD = r"""
import json, sys, time
import numpy as np
import torch
from kma_tpu_torch.devserve import (TorchDevServer, kernel_launches,
                                    reset_kernel_launches)
from kma_tpu_torch.config import Penalties
from kma_tpu_torch.mapping import scan_dense, scan_fast

# wide chunks a pass sends, counted where each scanner takes them
chunks = [0]


def counting(wide_chunks):
    def wrapped(*a, **k):
        for x in wide_chunks(*a, **k):
            chunks[0] += 1
            yield x
    return wrapped


for mod in (scan_dense, scan_fast):
    mod.wide_chunks = counting(mod.wide_chunks)

db, reads, L, passes, label = sys.argv[1:6]
L, passes = int(L), int(passes)
data = np.load(reads)
codes, lengths = data["codes"], data["lengths"]
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
srv = TorchDevServer(db, batch=2048, device=dev)
t_build = time.perf_counter() - t0
t0 = time.perf_counter()
srv.warm([L], verbose=False)
t_warm = time.perf_counter() - t0
pen = Penalties()
meta = {"op": "dense", "M": pen.M, "MM": pen.MM, "U": pen.U, "W1": pen.W1,
        "exhaustive": False, "proxi_frac": None, "pipeline": True}
reqs = [{"codes": codes[o: o + %(slice)d], "lengths": lengths[o: o + %(slice)d]}
        for o in range(0, len(codes), %(slice)d)]


def one_pass():
    # dispatch request k, then resolve request k-1: the daemon's order
    pending = None
    for a in reqs:
        h = srv._dense_dispatch(meta, a)
        if pending is not None:
            srv._dense_pack(*pending)
        pending = h
    srv._dense_pack(*pending)


graphs = getattr(srv, "graphs", None)
STATS = ("tier0_batches", "tier0_spills", "wide_reads")
one_pass()                                  # first sight of every shape
torch.cuda.synchronize()
srv.spans.reset()
reset_kernel_launches()
if graphs is not None:
    graphs.replays.clear()
for sc in srv.scanners.values():
    for k in STATS:
        if hasattr(sc, k):
            setattr(sc, k, 0)
chunks[0] = 0
torch.cuda.reset_peak_memory_stats(dev)
for _ in range(passes):
    one_pass()
torch.cuda.synchronize()
ms = list(srv.dense_ms)
stats = {k: sum(getattr(sc, k) for sc in srv.scanners.values())
         for k in STATS if all(hasattr(sc, k) for sc in srv.scanners.values())}
stats["wide_chunks"] = chunks[0]
peak = torch.cuda.max_memory_allocated(dev)
reserved = torch.cuda.max_memory_reserved(dev)
launches = kernel_launches()
replays = None if graphs is None else sum(graphs.replays.values())

from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    t0 = time.perf_counter()
    one_pass()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
ev = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA]
spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
busy, end = 0.0, float("-inf")
for a, b in spans:
    if b > end:
        busy += b - max(a, end)
        end = b
d = srv.didx
fp = d.footprint[0] if srv.scanner_kind == "dense" else None


def shape(k):
    # (tier, B, L) of a key: named fields, or a dense key of before them
    if hasattr(k, "tier"):
        return k.tier, k.B, k.L
    return (0 if k[10] else 1), k[1], k[11]


s = sorted(ms)
print(json.dumps({
    "label": label, "db": db.rsplit("/", 1)[-1], "L": L,
    "scanner": srv.scanner_kind,
    "V": getattr(d, "n_lists", None), "t_pad": getattr(d, "t_pad", None),
    "layout": None if fp is not None else (
        "mega" if d.mega else "cuckoo" if d.max_probe == 0 else "open"),
    "max_probe": d.max_probe,
    "requests_a_pass": len(reqs), "reads": int(len(codes)),
    "passes": passes, "build_s": t_build, "warm_s": t_warm,
    "dense_ms_median": s[len(s) // 2], "dense_ms_min": s[0],
    "dense_ms_max": s[-1], "dense_ms": ms,
    "profiled_pass_ms": wall,
    "busy_share": (busy / 1e3 / wall) if ev else None,
    "device_events_a_request": len(ev) / len(reqs),
    "peak_allocated_mb": peak / 2 ** 20, "peak_reserved_mb": reserved / 2 ** 20,
    "card_mb": torch.cuda.get_device_properties(dev).total_memory / 2 ** 20,
    "footprint_mb": None if fp is None else fp.total / 2 ** 20,
    "footprint_graphs_mb": None if fp is None
    else getattr(fp, "graphs", 0) / 2 ** 20,
    "workspace_mb": None if fp is None else fp.workspace / 2 ** 20,
    "kernel_launches": launches,
    "scan_stats": stats,
    "graph_replays": replays,
    "graphs": None if graphs is None else [
        dict(zip(("tier", "B", "L"), shape(k)),
             capture_s=graphs.capture_s[k], replays=graphs.replays[k])
        for k in graphs.graphs],
    "evictions": None if graphs is None
    else getattr(graphs, "evictions", None),
    "pool_mb": None if graphs is None else graphs.pool_bytes() / 2 ** 20,
    "faults": dict(srv.faults),
}))
"""


def load_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fastq_codes(np, path, L):
    """The reads of a FASTQ file as codes [n, L] (N past each read) and
    lengths."""
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    lut = np.full(256, 4, np.uint8)
    lut[list(b"ACGT")] = [0, 1, 2, 3]
    codes = np.full((len(seqs), L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = lut[np.frombuffer(s, np.uint8)]
    return codes, np.array([len(s) for s in seqs], np.int32)


def build_data(np, sm, work):
    """[(name, DB prefix, reads .npz, L)] of the panel and the scheme,
    the scheme twice (dense, then pair-stream: ``PAIR_STREAM``)."""
    env = sm.front_end_env(work)
    py_cli = [sys.executable, "-m", "kma_tpu"]
    o = lambda n: os.path.join(work, n)  # noqa: E731
    out = []
    t0 = time.time()
    seqs = sm.make_panel(o("panel.fsa"), np)
    sm.index_db(py_cli, env, o("panel.fsa"), o("panel"), o("panel.log"))
    sm.make_reads(o("panel.fq"), seqs, np)
    c, n = fastq_codes(np, o("panel.fq"), 128)
    np.savez(o("panel.npz"), codes=c, lengths=n)
    out.append(("panel", o("panel"), o("panel.npz"), 128))
    loci = sm.make_scheme(o("cg.fsa"), np, sm.N_LOCI)
    sm.index_db(py_cli, env, o("cg.fsa"), o("cg"), o("cg.log"))
    sm.make_isolate_reads(o("cg.fq"), loci, np, sm.N_CG_READS)
    del loci
    c, n = fastq_codes(np, o("cg.fq"), 192)
    np.savez(o("cg.npz"), codes=c, lengths=n)
    out.append(("cgmlst", o("cg"), o("cg.npz"), 192))
    out.append(("cgmlst_pair_stream", o("cg"), o("cg.npz"), 192))
    print("# dense_ab: data built in %.1f s" % (time.time() - t0),
          file=sys.stderr, flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout's root; give two (A, B)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "dense_ab.jsonl"))
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dense_ab: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    trees = {chr(ord("A") + i): os.path.abspath(t)
             for i, t in enumerate(a.tree)}
    work = tempfile.mkdtemp(prefix="kma_dense_ab_")
    data = build_data(np, load_smoke(), work)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    child = CHILD % {"slice": SLICE}
    rc = 0
    with open(a.out, "a") as out:
        for name, db, reads, L in data:
            for t in a.order:
                env = dict(os.environ, PYTHONPATH=trees[t])
                if name in PAIR_STREAM:
                    env["KMA_TPU_DENSE_BUDGET_MB"] = "0"
                r = subprocess.run(
                    [sys.executable, "-c", child, db, reads, str(L),
                     str(a.passes), t], cwd=trees[t], env=env,
                    capture_output=True, text=True, timeout=900)
                if r.returncode != 0:
                    print("dense_ab: %s on tree %s exited %d:\n%s"
                          % (name, t, r.returncode, r.stderr[-3000:]),
                          file=sys.stderr)
                    rc = 1
                    continue
                rec = json.loads(r.stdout.strip().splitlines()[-1])
                rec.update(card=smi, tree=trees[t], cell=name)
                line = json.dumps(rec)
                print(line, flush=True)
                out.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
