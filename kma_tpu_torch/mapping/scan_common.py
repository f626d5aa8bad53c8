"""Shared save_kmers scoring arithmetic (savekmers.c:2529-2625).

Port of kma_tpu/mapping/scan_common.py.  ``ScanParams`` keeps the JAX
dataclass's fields in the same order: ``dataclasses.astuple`` of it is
the statics tuple both packages build.  The score formulas work on
integer tensors; ``//`` and ``%`` floor as jnp's do.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import tracing


@dataclasses.dataclass(frozen=True)
class ScanParams:
    k: int
    mlen: int
    M: int
    MM: int
    U: int
    W1: int
    max_list: int
    exhaustive: bool
    max_probe: int
    run_cap: int = 64     # max value-list runs per read handled on device
    pair_cap: int = 1024  # max (run, template) pairs per read on device
    best_cap: int = 64    # max tie-list size returned per read
    small_ids: bool = False  # template ids fit int16


def _gap_mm_terms(gap, k, M, MM, U, W1):
    """The kmersize<gap branch (savekmers.c:2536-2557)."""
    g = gap - (k - 1)
    small = g <= 2
    mm_big = torch.clamp(g // k + (g % k != 0).to(g.dtype), min=2)
    mm = torch.where(small, g, mm_big)
    m = torch.where(small, 0, torch.minimum(torch.clamp(g - mm_big, max=k),
                                            mm_big))
    gap_opt = W1 + (g - 1) * U
    mm_opt = mm * MM + m * M
    return torch.where(gap_opt <= mm_opt, mm_opt, gap_opt)


def _run_transition_score(gap, p: ScanParams):
    """In-run contribution per consecutive same-list hit
    (savekmers.c:2529-2569)."""
    k, mlen = p.k, p.mlen
    M, MM, U, W1 = p.M, p.MM, p.U, p.W1
    match = gap == 0
    snp = (mlen <= gap) & (gap <= k)
    big = k < gap
    s_snp = k * M + MM
    s_big = k * M + _gap_mm_terms(gap, k, M, MM, U, W1)
    if mlen != k:
        s_small = gap * M + MM
    else:
        s_small = gap * M + W1 + (k - gap) * U
    return torch.where(match, M,
                       torch.where(snp, s_snp,
                                   torch.where(big, s_big, s_small)))


def _reconnect_score(gap, p: ScanParams, rc_branch):
    """Flush-time reconnect for an already-included template
    (savekmers.c:2590-2625 fw, :2901-2936 rc; the SNP case differs).
    rc_branch is a bool tensor broadcastable against gap."""
    k, mlen = p.k, p.mlen
    M, MM, U, W1 = p.M, p.MM, p.U, p.W1
    match = gap == 0
    snp = (mlen <= gap) & (gap <= k)
    big = k < gap
    s_snp = torch.where(rc_branch, k * M + MM, gap * M + MM)
    s_big = k * M + _gap_mm_terms(gap, k, M, MM, U, W1)
    if mlen != k:
        s_small = gap * M + MM
    else:
        s_small = gap * M + (k - gap) * U + W1
    return torch.where(match, M,
                       torch.where(snp, s_snp,
                                   torch.where(big, s_big, s_small)))


def rc_batch(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement inside the padded buffer, LEFT-aligned
    (row i holds revcomp(read i) in columns [0, len_i), code 4 after):
    the pair-stream scan's layout."""
    L = codes.shape[-1]
    idx = lengths.long()[:, None] - 1 - torch.arange(
        L, device=codes.device)[None, :]
    ok = idx >= 0
    got = torch.gather(codes, 1, torch.where(ok, idx, 0))
    comp = torch.where(got < 4, 3 - got, got)
    return torch.where(ok, comp, 4).to(torch.uint8)


def _padded(codes, lengths, rows: int, device: torch.device):
    """A batch padded to ``rows`` rows with empty reads (N codes, length
    0), as uint8 and int32 tensors on ``device``."""
    c = np.full((rows, codes.shape[1]), 4, np.uint8)
    n = np.zeros(rows, np.int32)
    c[: len(codes)] = codes
    n[: len(lengths)] = lengths
    return torch.from_numpy(c).to(device), torch.from_numpy(n).to(device)


def _step(call, codes, lengths, rows: int, device: torch.device, tier: int,
          flat_cap: int):
    """``call`` on a batch padded to ``rows`` rows, recorded as its
    ``upload`` and ``device`` spans where a daemon's request
    is being served (``tracing``)."""
    req = tracing.current()
    if req is None:
        return call(*_padded(codes, lengths, rows, device), tier, flat_cap)
    t0 = time.perf_counter()
    return req.step(t0, call, (*_padded(codes, lengths, rows, device),
                               tier, flat_cap))


def dispatch_tier0(call, codes, lengths, batch: int, flat_cap: int,
                   device: torch.device) -> list:
    """Queue ``call(codes_t, lens_t, 0, flat_cap)`` on every ``batch``-row
    slice of a read set, without syncing.  Every slice is padded to
    ``batch`` rows, so a read set's batches share one static shape: on
    a CUDA card the ``call`` of either scanner (dense or pair-stream)
    replays one step graph for all of them (``scan_dense.StepGraphs``)."""
    return [_step(call, codes[o: o + batch], lengths[o: o + batch], batch,
                  device, 0, flat_cap)
            for o in range(0, codes.shape[0], batch)]


#: reads a chunk of the wide tier
WIDE_ROWS = 512


def wide_chunks(call, codes, lengths, sel, best_cap: int,
                device: torch.device, rows: int = WIDE_ROWS):
    """Tier-1 pass of ``call`` over the reads ``sel`` on compacted chunks
    of ``rows`` rows.  The flat buffer holds a chunk's worst case, 2 *
    ``best_cap`` ids a read (2**21 ids, 8 MB, at the wide tier's caps),
    so no tie list is cut short; only its used prefix comes back.  Every
    chunk is padded to ``rows`` rows: one static shape, one step graph
    of either scanner on a CUDA card.  Each chunk syncs before the next
    is sent (its ids are cut to their used prefix on the host).

    Yields (reads, meta [n, 2] int32, packed ids int32, n_out [n])."""
    flat_cap = rows * 2 * best_cap
    for o in range(0, len(sel), rows):
        s = sel[o: o + rows]
        meta, flat = _step(call, codes[s], lengths[s], rows, device, 1,
                           flat_cap)
        with tracing.span(tracing.DEVICE_WAIT):
            meta = meta[: len(s)].cpu().numpy()
            n_out = (meta[:, 1] >> 3).astype(np.int64)
            flat = flat[: int(n_out.sum())].cpu().numpy()
        yield s, meta, flat.astype(np.int32), n_out


def _segment_starts(codes: torch.Tensor) -> torch.Tensor:
    """For each position, the start of its N-free segment."""
    L = codes.shape[-1]
    pos = torch.arange(L, device=codes.device, dtype=torch.int64)[None, :]
    lastN = torch.cummax(torch.where(codes == 4, pos, -1), dim=1).values
    return lastN + 1
