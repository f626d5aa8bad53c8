"""The plain reference of the dense op: KMA's ``-1t1`` read scan
(save_kmers, savekmers.c:2442-2833) worked out again from the
configuration's templates and the reads, in PyTorch and Python.

It imports nothing of the program and reads none of its files: the
k-mer lists come from the templates the benchmark generated
(``dbgen``), not from the index.  ``KmerMap`` holds, for every k-mer
of the templates, the templates that hold it (ascending, as the index
lists them) and a list id that two k-mers share exactly when their
template sets are equal (the index deduplicates identical lists); ids
are keyed by the list's length and three polynomial hashes modulo
primes under 2**31.  ``scan`` follows the reference's arithmetic read
by read (``_scan_strand``, ``get_match``, the strand merge): one read's
answer is (signed score, mode 0-3, template ids).

``run_work`` counts, for a set of reads, what one run-scoring pass needs
(``kernel_bound``): live runs, membership hits and distinct lists.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

K = 16
#: three primes under 2**31 and their multipliers
_HASHES = ((2147483629, 1000003), (2147483587, 998244353 % 2147483587),
           (2147483563, 1234567891 % 2147483563))
TID_BITS = 24


class KmerMap:
    """Every k-mer of the templates -> the templates holding it."""

    def __init__(self, codes: np.ndarray, offsets: np.ndarray,
                 device="cpu", k: int = K):
        self.k = k
        self.device = torch.device(device)
        dev = self.device
        total = len(codes)
        n = total - k + 1
        if len(offsets) - 1 >= 1 << TID_BITS:
            raise ValueError("too many templates for the map's key")
        c = torch.from_numpy(np.ascontiguousarray(codes)).to(dev).long()
        km = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(k):
            km = (km << 2) | c[j: j + n]
        del c
        ends = torch.from_numpy(np.asarray(offsets[1:], np.int64)).to(dev)
        pos = torch.arange(n, device=dev)
        tid = torch.searchsorted(ends, pos, right=True)
        ok = pos + k <= ends[tid.clamp(max=len(ends) - 1)]
        key = (km[ok] << TID_BITS) | (tid[ok] + 1)
        del km, pos, tid, ok
        key = torch.unique(key)                 # sorted, each pair once
        kmer = key >> TID_BITS
        self.flat = (key & ((1 << TID_BITS) - 1)).to(torch.int64)
        del key
        first = torch.ones(len(kmer), dtype=torch.bool, device=dev)
        first[1:] = kmer[1:] != kmer[:-1]
        starts = torch.nonzero(first).flatten()
        self.kmers = kmer[starts]
        self.start = starts
        counts = torch.diff(torch.cat([starts, torch.tensor(
            [len(kmer)], device=dev)]))
        self.count = counts
        grp = torch.cumsum(first.long(), 0) - 1
        within = torch.arange(len(kmer), device=dev) - starts[grp]
        del kmer, first
        cols = [counts]
        wmax = int(within.max()) + 1 if len(within) else 1
        for p, b in _HASHES:
            pw = [1]
            for _ in range(wmax - 1):
                pw.append(pw[-1] * b % p)
            term = (self.flat % p) * torch.tensor(pw, device=dev)[within] % p
            h = torch.zeros(len(starts), dtype=torch.int64, device=dev)
            h.index_add_(0, grp, term)
            cols.append(h % p)
        _, self.list_id = torch.unique(torch.stack(cols, 1), dim=0,
                                       return_inverse=True)
        self._lists: Dict[int, Tuple[int, ...]] = {}

    def lookup(self, q: torch.Tensor):
        """(found, group index) of k-mers ``q``."""
        i = torch.searchsorted(self.kmers, q).clamp(max=len(self.kmers) - 1)
        return self.kmers[i] == q, i

    def templates(self, g: int) -> Tuple[int, ...]:
        t = self._lists.get(g)
        if t is None:
            s = int(self.start[g])
            t = tuple(self.flat[s: s + int(self.count[g])].tolist())
            self._lists[g] = t
        return t


def strand_codes(codes: np.ndarray, lengths: np.ndarray):
    """Both strands of each read, left aligned: [2, N, L] int64 (4 past
    the read)."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).long()
    n = torch.from_numpy(np.asarray(lengths, np.int64))
    L = c.shape[1]
    idx = n[:, None] - 1 - torch.arange(L)[None, :]
    ok = idx >= 0
    rc = torch.gather(c, 1, idx.clamp(min=0))
    rc = torch.where(ok & (rc < 4), 3 - rc, torch.full_like(rc, 4))
    if ((c < 4) != (torch.arange(L)[None, :] < n[:, None])).any():
        raise ValueError("the reference takes reads of A/C/G/T only")
    return torch.stack([c, rc])


def windows(m: KmerMap, codes: np.ndarray, lengths: np.ndarray):
    """(hit [2, N, W] bool, group [2, N, W], list id [2, N, W]) of every
    window of both strands."""
    k = m.k
    s = strand_codes(codes, lengths).to(m.device)
    W = s.shape[2] - k + 1
    km = torch.zeros(s.shape[:2] + (W,), dtype=torch.int64, device=m.device)
    for j in range(k):
        km = (km << 2) | (s[..., j: j + W] & 3)
    n = torch.from_numpy(np.asarray(lengths, np.int64)).to(m.device)
    valid = torch.arange(W, device=m.device)[None, None, :] \
        <= (n - k)[None, :, None]
    found, g = m.lookup(km)
    hit = found & valid
    return hit, g, torch.where(hit, m.list_id[g], -1)


def _gap_mm(g: int, k: int, M: int, MM: int, U: int, W1: int):
    """(Ms, MMs, Us, W1s) added for k < gaps (savekmers.c:2536-2557)."""
    g = g - (k - 1)
    if g <= 2:
        mm, mt = g, 0
    else:
        mm = max(2, g // k + (1 if g % k else 0))
        mt = min(min(g - mm, k), mm)
    if (W1 + (g - 1) * U) <= (mm * MM + mt * M):
        return k + mt, mm, 0, 0
    return k, 0, g - 1, 1


def _strand(m: KmerMap, pos: List[int], grp: List[int], lid: List[int],
            pen, rc_branch: bool):
    """One strand of save_kmers: (best score, its templates in the order
    they were first included)."""
    k, mlen = m.k, m.k
    M, MM, U, W1 = pen
    if not pos:
        return 0, []
    score: Dict[int, int] = {}
    ext: Dict[int, int] = {}
    best: List[int] = []
    last = lastg = -1
    Ms = MMs = Us = W1s = 0
    HIT = 0
    for i in range(len(pos)):
        j, v = pos[i], lid[i]
        gaps = j - pos[i - 1] - 1 if i else 0
        if i and v == last:
            if gaps == 0:
                Ms += 1
            elif mlen <= gaps <= k:
                Ms += k
                MMs += 1
            elif k < gaps:
                a, b, c, d = _gap_mm(gaps, k, M, MM, U, W1)
                Ms += a
                MMs += b
                Us += c
                W1s += d
            elif mlen != k:
                Ms += gaps
                MMs += 1
            else:
                Ms += gaps
                W1s += 1
                Us += k - gaps
            HIT = j
            continue
        if i:
            add = Ms * M + MMs * MM + Us * U + W1s * W1
            for t in m.templates(lastg):
                score[t] += add
                ext[t] = HIT
            HIT = j - 1
        for t in m.templates(grp[i]):
            if t not in ext:            # not included yet
                score[t] = k * M
                best.append(t)
                continue
            g = HIT - ext[t]
            if g == 0:
                s = M
            elif mlen <= g <= k:
                s = k * M + MM if rc_branch else g * M + MM
            elif k < g:
                a, b, c, d = _gap_mm(g, k, M, MM, U, W1)
                s = k * M + (a - k) * M + b * MM + c * U + d * W1
            elif mlen != k:
                s = g * M + MM
            else:
                s = g * M + (k - g) * U + W1
            score[t] += s
        last, lastg = v, grp[i]
        HIT = j
        Ms = MMs = Us = W1s = 0
    add = Ms * M + MMs * MM + Us * U + W1s * W1
    for t in m.templates(lastg):
        score[t] += add
    top, ties = 0, []
    for t in best:
        s = max(score[t], 0)
        if s > top:
            top, ties = s, [t]
        elif s == top:
            ties.append(t)
    return top, ties


def scan(m: KmerMap, codes: np.ndarray, lengths: np.ndarray, pen,
         exhaustive: bool = False):
    """The reference's answer to each read: [(signed score, mode,
    template ids)], mode 0 unmapped, 1 forward, 2 reverse, 3 both
    (forward ids then reverse ids negated)."""
    k = m.k
    hit, g, lid = windows(m, codes, lengths)
    hit, g, lid = hit.cpu().numpy(), g.cpu().numpy(), lid.cpu().numpy()
    out = []
    for r in range(codes.shape[0]):
        res = []
        for s in (0, 1):
            h = hit[s, r]
            # the quick probe: a hit at every k-th window (N-free reads)
            if not exhaustive and not h[::k].any():
                res.append((0, []))
                continue
            p = np.flatnonzero(h)
            res.append(_strand(m, (p + k - 1).tolist(), g[s, r][p].tolist(),
                               lid[s, r][p].tolist(), pen, s == 1))
        (bf, tf), (br, tr) = res
        if (bf <= 0 and br <= 0) or (k > bf and k > br):
            out.append((0, 0, ()))
        elif bf > br:
            out.append((bf, 1, tuple(tf)))
        elif bf < br:
            out.append((br, 2, tuple(tr)))
        else:
            out.append((-bf, 3, tuple(tf) + tuple(-t for t in tr)))
    return out


def run_work(m: KmerMap, codes: np.ndarray, lengths: np.ndarray,
             exhaustive: bool = False):
    """(live runs, membership hits, distinct lists) of one scoring pass
    over both strands of the reads: a run is a stretch of hits of one
    list (misses between do not break it), its hits the list's
    templates; strands that fail the quick probe hold none."""
    hit, g, lid = windows(m, codes, lengths)
    prev = torch.full_like(lid[..., :1], -1)
    # the last hit's list before each window, carried over misses
    W = lid.shape[-1]
    pos = torch.arange(W, device=lid.device).expand_as(lid)
    last_hit = torch.cummax(torch.where(hit, pos, -1), dim=-1).values
    before = torch.cat([prev.expand(*lid.shape[:-1], 1),
                        torch.gather(lid, -1, last_hit[..., :-1].clamp(
                            min=0)).masked_fill(last_hit[..., :-1] < 0, -1)],
                       dim=-1)
    start = hit & (lid != before)
    if not exhaustive:
        probe = hit[..., ::m.k].any(-1, keepdim=True)
        start = start & probe
    runs = int(start.sum())
    hits = int(m.count[g[start]].sum()) if runs else 0
    lists = int(torch.unique(lid[start]).numel()) if runs else 0
    return runs, hits, lists
