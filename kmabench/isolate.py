"""Reads of simulated isolates, the one read generator every traffic mix
uses; a mix's ``isolate`` entry gives its parameters:

- ``genes``: ``"one_per_group"`` (one template of every group: an
  allele of every locus of a scheme) or a count (that many templates,
  each of another group: acquired genes of a panel);
- ``background_bp``: a random genome of that length that the genes are
  inserted into at random points, reads drawn uniformly over it (0: no
  genome, each read drawn inside one gene, genes weighted by the reads
  they hold);
- ``read_bp``, ``substitution_rate`` (each base substituted with that
  chance), ``rc_share`` (reads reverse-complemented).

Everything is drawn from a ``numpy`` generator the caller seeds.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

COMP = np.array([3, 2, 1, 0], np.uint8)


def pick_genes(groups: np.ndarray, spec, rng: np.random.Generator
               ) -> np.ndarray:
    """Template indices (0-based) of one isolate's genes."""
    order = np.argsort(groups, kind="stable")
    bounds = np.flatnonzero(np.r_[True, groups[order][1:]
                                  != groups[order][:-1], True])
    lo, hi = bounds[:-1], bounds[1:]
    if spec == "one_per_group":
        which = np.arange(len(lo))
    else:
        which = np.sort(rng.choice(len(lo), int(spec), replace=False))
    pick = lo[which] + (rng.random(len(which))
                        * (hi[which] - lo[which])).astype(np.int64)
    return order[pick]


def genome(codes, offsets, genes, background_bp: int,
           rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """A random background with ``genes`` inserted at random points:
    (genome codes, the genes' start in it)."""
    bg = rng.integers(0, 4, background_bp, dtype=np.uint8)
    at = np.sort(rng.integers(0, background_bp + 1, len(genes)))
    parts, starts, prev, pos = [], [], 0, 0
    for g, a in zip(genes, at):
        parts.append(bg[prev:a])
        pos += a - prev
        starts.append(pos)
        gene = codes[offsets[g]: offsets[g + 1]]
        parts.append(gene)
        pos += len(gene)
        prev = a
    parts.append(bg[prev:])
    return np.concatenate(parts), np.asarray(starts, np.int64)


def reads(codes, offsets, groups, iso: Dict, n: int,
          rng: np.random.Generator):
    """(reads [n, read_bp] uint8, the isolate's genes)."""
    L = iso["read_bp"]
    genes = pick_genes(groups, iso["genes"], rng)
    if iso["background_bp"]:
        seq, _ = genome(codes, offsets, genes, iso["background_bp"], rng)
        starts = rng.integers(0, len(seq) - L + 1, n)
    else:
        seq = codes
        room = (offsets[genes + 1] - offsets[genes] - L + 1).astype(
            np.float64)
        which = rng.choice(len(genes), n, p=room / room.sum())
        starts = offsets[genes[which]] + (rng.random(n)
                                          * room[which]).astype(np.int64)
    r = seq[starts[:, None] + np.arange(L)[None, :]]
    ne = rng.binomial(n * L, iso["substitution_rate"])
    flat = r.reshape(-1)
    at = rng.integers(0, n * L, ne)
    flat[at] = (flat[at] + rng.integers(1, 4, ne, dtype=np.uint8)) % 4
    rc = rng.random(n) < iso["rc_share"]
    r[rc] = COMP[r[rc][:, ::-1]]
    return r, genes


def palindrome(codes, offsets, L: int) -> np.ndarray:
    """A read equal to its own reverse complement, made of the first
    template's opening bases: its strands score alike, which sends it
    down the dense op's wide tier (the warm-up's way to reach every
    shape a window can)."""
    half = codes[offsets[0]: offsets[0] + L // 2]
    r = np.concatenate([half, COMP[half[::-1]]])
    return np.concatenate([r, half[: L - len(r)]]) if len(r) < L else r
