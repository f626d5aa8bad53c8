"""The configurations' seeded template sets, and their cache.

A configuration file (``kmabench/configs/<name>.json``) names its DB's
``generator``, the generator's parameters and its ``db_seed``; the
generator's output is a deterministic function of them.
``prepare(cfg)`` writes, once a checkout, the FASTA, the template
arrays and the index (``kma_index.write_index``) under
``kmabench/cache/<name>/<hash>/``, the hash that of the configuration
file and of this module and the writer, and returns its paths.

Generators (copies of chip_smoke.py's ``make_panel`` and
``make_scheme``, which set the repository's records; same random calls
in the same order):

- ``panel``: families of 1-5 variants of a random ancestor of
  ``template_bp`` at ``divergence`` substitutions, until ``templates``;
  a family is a group.
- ``scheme``: ``loci`` loci of ``locus_bp``, ``alleles_per_locus`` alleles,
  every allele ``snps`` substitutions from its locus ancestor; a locus
  is a group.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import time
from typing import Dict

import numpy as np

from . import kma_index

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "cache")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def panel(p: Dict, rng: np.random.Generator):
    """(sequences, group of each)."""
    lo, hi = p["template_bp"]
    dlo, dhi = p["divergence"]
    flo, fhi = p["family_size"]
    seqs, groups = [], []
    fam = 0
    while len(seqs) < p["templates"]:
        L = int(rng.integers(lo, hi + 1))
        anc = rng.integers(0, 4, L).astype(np.uint8)
        for _ in range(int(rng.integers(flo, fhi + 1))):
            if len(seqs) == p["templates"]:
                break
            v = anc.copy()
            ne = rng.binomial(L, rng.uniform(dlo, dhi))
            pos = rng.integers(0, L, ne)
            v[pos] = (v[pos] + rng.integers(1, 4, ne)) % 4
            seqs.append(v)
            groups.append(fam)
        fam += 1
    return seqs, groups


def scheme(p: Dict, rng: np.random.Generator):
    lo, hi = p["locus_bp"]
    slo, shi = p["snps"]
    A = p["alleles_per_locus"]
    seqs, groups = [], []
    for locus in range(p["loci"]):
        L = int(rng.integers(lo, hi + 1))
        al = np.repeat(rng.integers(0, 4, L).astype(np.uint8)[None, :], A,
                       axis=0)
        for a in range(A):
            ns = int(rng.integers(slo, shi + 1))
            pos = rng.choice(L, ns, replace=False)
            al[a, pos] = (al[a, pos] + rng.integers(1, 4, ns)) % 4
            seqs.append(al[a])
            groups.append(locus)
    return seqs, groups


GENERATORS = {"panel": panel, "scheme": scheme}


def _names(kind: str, groups, A: int):
    if kind == "scheme":
        return [b"locus%d_%d" % (g + 1, i % A + 1)
                for i, g in enumerate(groups)]
    return [b"tpl%d" % i for i in range(len(groups))]


def db_hash(cfg: Dict) -> str:
    blob = json.dumps(cfg, sort_keys=True).encode()
    with open(os.path.join(HERE, "dbgen.py"), "rb") as f:
        blob += f.read()
    with open(os.path.join(HERE, "kma_index.py"), "rb") as f:
        blob += f.read()
    return hashlib.sha256(blob).hexdigest()[:16]


def prepare(cfg: Dict, cache: str = CACHE, log=print) -> Dict[str, str]:
    """The configuration's DB, built once under ``cache`` under a lock
    (a second process waits for the first): {"dir", "fasta", "prefix",
    "codes", "offsets", "groups"}."""
    d = os.path.join(cache, cfg["name"], db_hash(cfg))
    out = dict(dir=d, fasta=os.path.join(d, "db.fsa"),
               prefix=os.path.join(d, "db"),
               codes=os.path.join(d, "codes.npy"),
               offsets=os.path.join(d, "offsets.npy"),
               groups=os.path.join(d, "groups.npy"))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(os.path.join(d, "done")):
            return out
        t0 = time.perf_counter()
        seqs, groups = GENERATORS[cfg["generator"]](
            cfg, np.random.default_rng(cfg["db_seed"]))
        names = _names(cfg["generator"], groups,
                       cfg.get("alleles_per_locus", 1))
        lens = np.array([len(s) for s in seqs], np.int64)
        offsets = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        codes = np.concatenate(seqs)
        with open(out["fasta"], "wb") as f:
            for i, n in enumerate(names):
                f.write(b">" + n + b"\n")
                f.write(ACGT[codes[offsets[i]: offsets[i + 1]]].tobytes())
                f.write(b"\n")
        np.save(out["codes"], codes)
        np.save(out["offsets"], offsets)
        np.save(out["groups"], np.asarray(groups, np.int64))
        t1 = time.perf_counter()
        # the index is written from the FASTA, as kma index reads it
        kma_index.write_index(*kma_index.read_fasta(out["fasta"]),
                              out["prefix"])
        with open(os.path.join(d, "done"), "w") as f:
            f.write("%.3f %.3f\n" % (t1 - t0, time.perf_counter() - t1))
        log("# kmabench: built %s's DB in %.1f s (templates %.1f s, index "
            "%.1f s)" % (cfg["name"], time.perf_counter() - t0, t1 - t0,
                         time.perf_counter() - t1))
    return out
