"""Dense-template batched save_kmers scanner (port of
kma_tpu/mapping/scan_dense.py, the -1t1 device scan of savekmers.c:2442).

Per batch of reads, both strands side by side (G = 2B strand rows):

1. k-mer windows -> hash lookup of a value-LIST id per window,
2. run compaction: consecutive windows with the same list id form a
   run; each run's start, end, list id and in-run score,
3. the run-scoring kernel (ops/scan_kernel.py) applies the reference's
   flush logic (savekmers.c:2573-2625) for every template of each row,
4. tie lists and the fw/rc merge decision (savekmers.c:2750-2833) are
   extracted and packed into a compact per-batch ``meta``/``flat`` pair.

Every array equals the JAX package's; the port drops only what served
the TPU: the transposed ``bits_t`` layout, the run-count row sort of the
Pallas path and the slim 2-bit upload formats.  Reads whose runs or tie
lists overflow the device caps come back flagged for the wide rescan
or, past that, for the client's host scanner -- the JAX package's own
semantics.

Which image serves a DB is decided by its footprint on the device
(``dense_footprint``): the bit table (V·t_pad/8 bytes), the hash tables,
the workspace of two batches in flight, one chunk of the chain op and
the step graphs' inputs, outputs and output copies (``graph_bytes``),
each term reckoned from the tensors the scan allocates (a batch of long
reads holds fewer of them), against the device's free memory when the
image is built (``torch.cuda.mem_get_info``; the host's physical memory
for the CPU) or an explicit budget (``mem_budget_bytes``,
``KMA_TPU_DENSE_BUDGET_MB``).  The table is built on the device in row
chunks, so no host copy of it exists.

On CUDA cards an image's batches replay captured CUDA graphs of the
step, one set a static shape (``StepGraphs``), as the JAX package runs
one jitted program a static shape: one graph of the whole step on an
unsharded image; on a sharded one a graph of each segment of the step
between two crossings of devices (``ShardedStep``), each captured on its
own device, with copies between them and no host sync.

A DB whose footprint is over one device's budget keeps the dense
scan when two or more devices are given: the table's template columns
are split over them (``DenseIndex.from_host(..., devices=...)``, the
JAX package's ('db',) mesh, scan_dense.py:94-195), the hash tables stay
on the first (primary) device.  What GSPMD computes there is explicit
here: the front half runs once on the primary and its run arrays go to
every shard; each shard runs the run-scoring kernel on its own columns;
both epilogues reduce in two phases, so no [G, T] block leaves its
device: the shards' row maxima meet on the primary as the global best,
which goes back to each shard to select its ties and take its local
top-k under the global (first, template id) key; the candidates merge
on the primary.  The key is unique, so the result is the unsharded one
bit for bit.  Copies between devices are ``tensor.to(device)`` (a peer
copy between cards, nothing when two shards share a device), and none
syncs the host.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import DeviceLike, resolve, resolve_devices
from ..index.format import KmaIndex
from ..ops.scan_kernel import run_score_rows
from .device_index import (_cuckoo_build, _cuckoo_tsize, as_i32,
                           batch_kmers, lookup_voffsets, valid_windows)
from .scan_common import (WIDE_ROWS, ScanParams, _run_transition_score,
                          _segment_starts, dispatch_tier0, wide_chunks)

BIG = 0x3FFFFFFF
#: (run_cap, best_cap) of tier 0 and of the wide tier
TIERS = ((48, 256), (192, 2048))
#: the daemon's reads a tier-0 batch
DEFAULT_BATCH = 2048
#: the read pad the footprint counts a batch at: longer reads go in
#: batches of fewer rows (batch_rows), so a batch never holds more
#: windows than a full one of reads to 256 bp
FOOTPRINT_READ_PAD = 256
#: peak bytes of the front half (the strands' codes and _strand_runs) a
#: strand row: this many a window plus FRONT_BYTES_A_RUN a run slot
#: (R + 1).  The measured peak (tests/test_torch_dense_budget.py, the
#: allocations the profiler records on the CPU, cuckoo and mega tables,
#: both tiers) is 120-129 a window at 16 a slot; on an H100 it stays
#: under the term (tests/test_torch_cuda.py)
FRONT_BYTES_A_WINDOW = 132
FRONT_BYTES_A_RUN = 16
#: batches whose workspaces are live at once: the pipelined dense op
#: dispatches request k+1 while request k resolves (devserve); on an
#: image that replays graphs (StepGraphs) one is the graphs' shared pool
#: and the other the eager work beside it (a capture's warm-up calls,
#: the other ops)
IN_FLIGHT = 2
#: tie ids a read of the flat buffer of a tier-0 batch
FLAT_HEADROOM = 24
#: graphs an image's StepGraphs holds at most: past it the least
#: recently replayed is dropped (keys are (B, L, tier) per penalty set;
#: the native client buckets L: 128, 192, 256, ...)
MAX_GRAPHS = 16
#: reads of a dense request whose output copies the footprint counts
#: (the card's KMA_DEVSLICE, envelope.py)
REQUEST_READS = 16384
#: windows (rows x (L - k + 1)) of one chunk of the daemon's chain op:
#: the CLIs' short-read requests (16,384 reads of 150 bp) take one
CHAIN_WINDOWS = 1 << 22
#: peak bytes a window of the chain lookup holds (measured as above:
#: 57.0 on a cuckoo table, 45.0 on a mega table; 57.04 on an H100 with
#: max_memory_allocated, the allocator's 512-byte rounding)
CHAIN_BYTES_A_WINDOW = 58
#: chain graphs an image's ``chain_graphs`` holds at most (keys are the
#: rows classes of chain_device.CHAIN_ROWS a read pad)
CHAIN_GRAPHS = 4
#: bytes a window a chain graph's static inputs and outputs hold: its
#: codes (1 a base, L/W <= 1.14 at the smallest pad) and lengths, its
#: two int32 rows
CHAIN_GRAPH_BYTES_A_WINDOW = 10
#: the other ops' headroom the primary's footprint reserves: one chain
#: chunk's peak and the chain graphs' static buffers (392 MiB); the
#: daemon answers its NW and pileup ops in pieces within it
OPS_BYTES = (CHAIN_BYTES_A_WINDOW + CHAIN_GRAPHS * CHAIN_GRAPH_BYTES_A_WINDOW
             ) * CHAIN_WINDOWS
#: int64 words a chunk of the table build accumulates (256 MB)
_BUILD_CHUNK_WORDS = 1 << 25


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def batch_rows(rows: int, L: int, k: int) -> int:
    """Reads a batch of reads padded to L holds: ``rows``, or fewer when
    L is past FOOTPRINT_READ_PAD, so that its windows stay within those
    of ``rows`` reads at that pad (one read at least)."""
    W, W_pad = L - k + 1, FOOTPRINT_READ_PAD - k + 1
    return rows if W <= W_pad else max(1, rows * W_pad // W)


def batch_workspace(G: int, R: int, cols: int, t_pad: int, best_cap: int,
                    merged: bool, L: int, k: int
                    ) -> Dict[str, int]:
    """Bytes of one batch's tensors on a device holding ``cols`` template
    columns, by what allocates them: G strand rows padded to L, run cap
    R; ``merged`` is tier 0's single-strand-choice epilogue (its ties are
    taken on G/2 chosen rows).  The terms are summed, though the front
    half's window tensors are freed before the epilogue allocates the rest:
    that slack also holds the shards' candidates a sharded primary
    merges."""
    n_sel = G // 2 if merged else G
    W = max(L - k + 1, 1)
    return {
        # the strands' codes, the front half's window tensors, the runs
        "front": G * (FRONT_BYTES_A_WINDOW * W
                      + FRONT_BYTES_A_RUN * (R + 1)),
        # the kernel's [G, T] int32 score and first
        "score_first": 2 * G * cols * 4,
        # the included mask and its complement, [G, T] bool
        "clip_masks": 2 * G * cols,
        # the chosen strand's score and first rows, [G/2, T] int32
        "chosen_rows": 2 * n_sel * cols * 4 if merged else 0,
        # included, selected and its complement, [n, T] bool
        "tie_masks": 3 * n_sel * cols,
        # the fused or unfused top-k key, [n, T] int64
        "keys": n_sel * cols * 8,
        # top-k values and ids, the shards' merge and the unfused sort,
        # [n, MB] int64 each
        "candidates": 6 * n_sel * min(best_cap, t_pad) * 8,
    }


def graph_bytes(batch: int, t_pad: int, L: int = FOOTPRINT_READ_PAD,
                k: int = 16) -> int:
    """Bytes the step graphs of an unsharded image hold beside their
    shared pool (whose intermediates are one batch's workspace, counted
    in IN_FLIGHT): MAX_GRAPHS graphs' static inputs and outputs at the
    larger tier's, and the output copies of IN_FLIGHT requests of
    REQUEST_READS reads and of one wide chunk (each replay's meta and
    flat, copied out before the next replay).  Ids count 4 bytes."""
    rows0, rows1 = batch_rows(batch, L, k), batch_rows(WIDE_ROWS, L, k)
    out0 = rows0 * 8 + FLAT_HEADROOM * rows0 * 4           # meta, flat
    out1 = rows1 * 8 + 2 * min(TIERS[1][1], t_pad) * rows1 * 4
    held = max(rows0 * (L + 4) + out0, rows1 * (L + 4) + out1)
    copies = IN_FLIGHT * -(-REQUEST_READS // rows0) * out0 + out1
    return MAX_GRAPHS * held + copies


def plan_bytes(batch: int, t_pad: int, n_db: int,
               L: int = FOOTPRINT_READ_PAD, k: int = 16) -> Tuple[int, ...]:
    """Bytes the step graphs of an image sharded over ``n_db`` devices
    hold on each shard beside its pool (whose intermediates are one
    batch's workspace, counted in IN_FLIGHT): the plans' buffers
    (``ShardedStep``: one set a device that every key shares, counted at
    each tier's shapes, since a key of the larger tier grows them) and,
    on the primary, the output copies ``graph_bytes`` counts."""
    W = max(L - k + 1, 1)
    cols = 32 * (t_pad // 32 // n_db)
    prim = shard = 0
    for tier, ((rc, bc), rows) in enumerate(zip(TIERS, (batch, WIDE_ROWS))):
        B = batch_rows(rows, L, k)
        z = _plan_sizes(B, max(1, min(rc, W)), n_db, min(bc, t_pad, cols),
                        tier == 0)
        flat = FLAT_HEADROOM * B if tier == 0 else 2 * min(bc, t_pad) * B
        # runs, the selection and a shard's candidates (int32), its row
        # maxima; the primary's codes, lengths, run_ov, the strand choice
        # (int64), every shard's maxima and candidates, meta and flat
        own = 4 * (z["runs"] + z["cands"] + 2 * z["G"])
        shard += own
        prim += own + B * (L + 4) + z["G"] + 16 * B + 4 * (
            (n_db - 1) * (z["G"] + z["cands"])) + 8 * B + 4 * flat
    rows0, rows1 = batch_rows(batch, L, k), batch_rows(WIDE_ROWS, L, k)
    out0 = rows0 * 8 + FLAT_HEADROOM * rows0 * 4
    out1 = rows1 * 8 + 2 * min(TIERS[1][1], t_pad) * rows1 * 4
    copies = IN_FLIGHT * -(-REQUEST_READS // rows0) * out0 + out1
    return (prim + copies,) + (shard,) * (n_db - 1)


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Bytes a dense image and its scans take on one device."""

    bits: int                   # its part of the membership table
    hash: int                   # the hash tables (primary only)
    batch: Dict[str, int]       # one batch's workspace, the larger tier
    #: the other ops' headroom (primary only): one chunk of the chain
    #: op (232 MiB), which also holds an NW request of the clients' size
    #: (a few MB) or the pileup counts of a template of a few Mbp (48 B
    #: a base), and the chain graphs' static inputs and outputs
    #: (CHAIN_GRAPHS chunks at CHAIN_GRAPH_BYTES_A_WINDOW)
    ops: int
    #: the step graphs' inputs, outputs and output copies (an unsharded
    #: image: ``graph_bytes``; a sharded one: ``plan_bytes``)
    graphs: int = 0

    @property
    def workspace(self) -> int:
        return sum(self.batch.values())

    @property
    def total(self) -> int:
        return self.bits + self.hash + IN_FLIGHT * self.workspace \
            + self.ops + self.graphs


def dense_footprint(n_lists: int, t_pad: int, hash_bytes: int,
                    n_db: int = 1, batch: int = DEFAULT_BATCH, k: int = 16,
                    L: int = FOOTPRINT_READ_PAD) -> Tuple[Footprint, ...]:
    """Each shard's footprint of an image of ``n_lists`` lists x
    ``t_pad`` templates over ``n_db`` devices, scanned in tier-0 batches
    of ``batch`` reads and wide chunks of WIDE_ROWS reads padded to L
    (FOOTPRINT_READ_PAD; longer reads take fewer rows a batch).  Shard
    0, the primary, also holds the hash tables and the other ops'
    headroom."""
    w = t_pad // 32 // n_db
    W = max(L - k + 1, 1)
    tiers = [batch_workspace(2 * rows, max(1, min(rc, W)), 32 * w, t_pad,
                             bc, tier == 0, L, k)
             for tier, ((rc, bc), rows) in enumerate(
                 zip(TIERS, (batch, WIDE_ROWS)))]
    ws = max(tiers, key=lambda t: sum(t.values()))
    graphs = (graph_bytes(batch, t_pad, L, k),) if n_db == 1 \
        else plan_bytes(batch, t_pad, n_db, L, k)
    return tuple(Footprint(n_lists * w * 4, hash_bytes if s == 0 else 0, ws,
                           OPS_BYTES if s == 0 else 0, graphs[s])
                 for s in range(n_db))


def _image_shape(idx: KmaIndex, n_db: int, batch: int):
    """(t_pad, the list offsets, each shard's footprint) of the image
    of ``idx`` over ``n_db`` devices; NotImplementedError for a DB the
    dense index does not take."""
    if idx.mlen > 16:
        raise NotImplementedError("dense index requires mlen <= 16")
    if idx.flag & 3:
        raise NotImplementedError("cmer (-m/-hc) DBs use the host scanner")
    # lcm keeps the word axis (t_pad // 32) divisible by n_db
    t_pad = _round_up(idx.db_size + 1, math.lcm(128, 32 * n_db))
    if idx.mega:
        offs = np.unique(idx.exist[idx.exist != idx.null_index])
        hash_bytes = 4 * int(idx.size) + 8               # exist, kv [1, 2]
    else:
        offs = np.unique(idx.value_index[: idx.n])
        hash_bytes = 4 + 16 * _cuckoo_tsize(int(idx.n))  # exist [1], kv
    return t_pad, offs.astype(np.int64), dense_footprint(
        len(offs), t_pad, hash_bytes, n_db, batch, int(idx.kmersize))


def image_footprint(idx: KmaIndex, n_db: int = 1,
                    batch: int = DEFAULT_BATCH) -> Tuple[Footprint, ...]:
    """Each shard's footprint of ``idx``'s dense image over ``n_db``
    devices, without building it."""
    return _image_shape(idx, n_db, batch)[2]


def device_budget(device: torch.device) -> int:
    """Bytes a device can give an image: a card's free memory now
    (``torch.cuda.mem_get_info``), the host's physical memory for the
    CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _budgets(devs, mem_budget_bytes: Optional[int]) -> Tuple[int, ...]:
    """The budget of each entry of ``devs``: the explicit one
    (``mem_budget_bytes``, else ``KMA_TPU_DENSE_BUDGET_MB``), else its
    device's, split evenly over the entries that name that device."""
    if mem_budget_bytes is None and "KMA_TPU_DENSE_BUDGET_MB" in os.environ:
        mem_budget_bytes = int(os.environ["KMA_TPU_DENSE_BUDGET_MB"]) << 20
    if mem_budget_bytes is not None:
        return (int(mem_budget_bytes),) * len(devs)
    free = {d: device_budget(d) for d in set(devs)}
    return tuple(free[d] // devs.count(d) for d in devs)


def _membership_bits(values: np.ndarray, offs: np.ndarray,
                     cnts: np.ndarray, t_pad: int, devs
                     ) -> Tuple[torch.Tensor, ...]:
    """The [V, t_pad/32] int32 membership table (word t // 32, bit t % 32
    of row v for each template t of list v), split into len(devs) column
    shards, built on the devices in row chunks: each chunk's words
    accumulate in int64 on devs[0] by ``index_add_``, which equals OR
    since a list holds a template once, and go out as int32 bits."""
    V, W32, n_db = len(offs), t_pad // 32, len(devs)
    w = W32 // n_db
    shards = tuple(torch.empty((V, w), dtype=torch.int32, device=d)
                   for d in devs)
    step = max(1, _BUILD_CHUNK_WORDS // max(W32, 1))
    for r0 in range(0, V, step):
        r1 = min(V, r0 + step)
        c = cnts[r0:r1]
        row = np.repeat(np.arange(r1 - r0, dtype=np.int64), c)
        pos = np.arange(len(row), dtype=np.int64) \
            - np.repeat(np.cumsum(c) - c, c)
        tid = values[np.repeat(offs[r0:r1] + 1, c) + pos]
        if ((np.diff(tid) <= 0) & (np.diff(row) == 0)).any():
            key = np.unique(row * t_pad + tid)
            row, tid = key // t_pad, key % t_pad
        tid_t = torch.from_numpy(tid).to(devs[0])
        word = torch.from_numpy(row).to(devs[0]) * W32 + (tid_t >> 5)
        acc = torch.zeros((r1 - r0) * W32, dtype=torch.int64,
                          device=devs[0])
        acc.index_add_(0, word, torch.ones_like(tid_t) << (tid_t & 31))
        words = as_i32(acc).view(r1 - r0, W32)
        for s, (d, tab) in enumerate(zip(devs, shards)):
            tab[r0:r1] = words[:, s * w: (s + 1) * w].to(d)
    return shards


def _placement(device: DeviceLike, devices):
    """(n_db, primary device, the shards' devices) of an image: one
    device unless ``devices`` names two or more."""
    devs = tuple(resolve_devices(devices)) if devices else ()
    if len(devs) < 2:
        dev = devs[0] if devs and device is None else resolve(device)
        return 1, dev, (dev,)
    if device is not None and resolve(device) != devs[0]:
        raise ValueError("device %s is not devices[0] (%s)"
                         % (device, devs[0]))
    return len(devs), devs[0], devs


@dataclasses.dataclass
class DenseIndex:
    """Device image of a frozen DB for the dense scanner.

    The hash payload is the value-LIST id (dense row); ``bits[list_id]``
    is the bit-packed template membership of that list (word t // 32,
    bit t % 32; uint32 bits held as int32).  Tie order needs no position
    table: the reference's value lists are ascending template id.  A
    sharded image holds shard s's words [s*w, (s+1)*w) of every row in
    ``shard_bits[s]`` on ``devices[s]``; the hash tables sit on
    ``device``, the primary (``devices[0]``)."""

    kmersize: int
    mlen: int
    flag: int
    db_size: int
    t_pad: int                  # padded template axis (multiple of 128)
    n_lists: int
    mega: bool
    size: int                   # cuckoo half size or mega mask+1
    max_probe: int              # 0 = cuckoo, 1 = megaMap direct
    max_list: int
    exist: torch.Tensor         # mega: [size] i32 list id or -1
    kv: torch.Tensor            # cuckoo: [2*size, 2] i32 (key, list id|-1)
    bits: Optional[torch.Tensor]   # [n_lists, t_pad//32] i32 membership
                                   # bits; None when sharded
    list_voff: np.ndarray       # host: list id -> values offset
    device: torch.device = torch.device("cpu")
    sharded: bool = False
    devices: Tuple[torch.device, ...] = ()
    #: [n_lists, t_pad//32//n_db] i32 a shard, contiguous on its device;
    #: ``(bits,)`` when unsharded
    shard_bits: Tuple[torch.Tensor, ...] = ()
    #: run-scoring calls made on each shard (a scan statistic)
    shard_calls: List[int] = dataclasses.field(default_factory=list)
    #: each shard's footprint and the budget it was held to (from_host)
    footprint: Tuple[Footprint, ...] = ()
    budget: Tuple[int, ...] = ()
    #: the dense step's graphs (an image on CUDA cards, sharded or not;
    #: None elsewhere: that image's scans run eager)
    graphs: Optional["StepGraphs"] = None
    #: the chain op's graphs (``chain_device.chain_lookup_dense``) on the
    #: primary, sharing the dense graphs' pools; None where ``graphs`` is
    chain_graphs: Optional["StepGraphs"] = None

    def __post_init__(self):
        if not self.shard_bits:
            self.shard_bits, self.devices = (self.bits,), (self.device,)
        if not self.shard_calls:
            self.shard_calls = [0] * len(self.shard_bits)
        if self.graphs is None and self.device.type == "cuda":
            from .chain_device import chain_graphs  # it imports this module
            self.graphs = StepGraphs()
            # the daemon's op lock serialises the chain op with the dense
            # op, so their graphs share one pool a card (StepGraphs)
            self.chain_graphs = chain_graphs(pools=self.graphs.pools)

    @classmethod
    def from_host(cls, idx: KmaIndex, device: DeviceLike = None,
                  mem_budget_bytes: Optional[int] = None,
                  devices: Optional[Sequence[DeviceLike]] = None,
                  batch: int = DEFAULT_BATCH) -> "DenseIndex":
        """Build the image from a loaded index (DenseIndex.from_host of
        the JAX package, natural bit layout) when each device's
        footprint (scanned in tier-0 batches of ``batch`` reads) fits
        its budget (``_budgets``), else NotImplementedError.  Two or
        more ``devices`` (``n_db``) shard the template columns over
        them, as the JAX ``n_db``; ``device`` is then None or
        ``devices[0]``."""
        n_db, device, devs = _placement(device, devices)
        t_pad, offs, fps = _image_shape(idx, n_db, batch)
        budgets = _budgets(devs, mem_budget_bytes)
        if any(f.total > b for f, b in zip(fps, budgets)):
            raise NotImplementedError("DB too large for dense membership")
        V = len(offs)
        values = np.asarray(idx.values, dtype=np.int64)
        cnts = values[offs].astype(np.int64)
        max_list = int(cnts.max()) if V else 0
        if max_list > 0x7FFE:
            raise NotImplementedError("value list too long for i16 table")

        if idx.mega:
            exist = np.full(idx.size, -1, dtype=np.int32)
            live = idx.exist != idx.null_index
            exist[live] = np.searchsorted(offs, idx.exist[live]
                                          ).astype(np.int32)
            kv, size, max_probe = np.zeros((1, 2), np.int32), idx.size, 1
        else:
            keys = idx.key_index[: idx.n].astype(np.uint32)
            rows = np.searchsorted(
                offs, idx.value_index[: idx.n].astype(np.int64))
            ck = _cuckoo_build(keys, rows, int(idx.n))
            if ck is None:  # pragma: no cover - cuckoo failure is rare
                raise NotImplementedError(
                    "cuckoo build failed for dense index")
            (kv, size), exist, max_probe = ck, np.zeros(1, np.int32), 0
        return cls._assemble(
            device, devs, _membership_bits(values, offs, cnts, t_pad, devs),
            exist=exist, kv=kv, list_voff=offs, kmersize=idx.kmersize,
            mlen=idx.mlen, flag=idx.flag, db_size=idx.db_size, t_pad=t_pad,
            n_lists=V, mega=idx.mega, size=size, max_probe=max_probe,
            max_list=max_list, footprint=fps, budget=budgets)

    @classmethod
    def from_jax_arrays(cls, device: DeviceLike, *, exist, kv, bits,
                        list_voff, kmersize, mlen, flag, db_size, t_pad,
                        n_lists, mega, size, max_probe, max_list,
                        devices: Optional[Sequence[DeviceLike]] = None
                        ) -> "DenseIndex":
        """Carry an image across from numpy arrays: the JAX
        DenseIndex's ``exist``, ``kv``, ``bits`` (uint32; of a sharded
        JAX image ``np.asarray`` gives the whole table) and
        ``list_voff`` plus its scalars (the port's weights converter;
        ``bits_t`` is not needed).  ``devices`` as in from_host."""
        n_db, device, devs = _placement(device, devices)
        bits = np.asarray(bits, np.uint32).view(np.int32)
        W32 = bits.shape[1]
        if W32 % n_db:
            raise ValueError("%d membership words do not split over %d "
                             "devices" % (W32, n_db))
        w = W32 // n_db
        # each shard a contiguous copy: a column slice is a strided view
        shards = tuple(
            torch.from_numpy(np.array(bits[:, s * w: (s + 1) * w],
                                      order="C")).to(d)
            for s, d in enumerate(devs))
        return cls._assemble(
            device, devs, shards, exist=exist, kv=kv, list_voff=list_voff,
            kmersize=kmersize, mlen=mlen, flag=flag, db_size=db_size,
            t_pad=t_pad, n_lists=n_lists, mega=mega, size=size,
            max_probe=max_probe, max_list=max_list)

    @classmethod
    def _assemble(cls, device, devs, shards, *, exist, kv, list_voff,
                  kmersize, mlen, flag, db_size, t_pad, n_lists, mega, size,
                  max_probe, max_list, **stats) -> "DenseIndex":
        sharded = len(devs) > 1
        return cls(kmersize=int(kmersize), mlen=int(mlen), flag=int(flag),
                   db_size=int(db_size), t_pad=int(t_pad),
                   n_lists=int(n_lists), mega=bool(mega), size=int(size),
                   max_probe=int(max_probe), max_list=int(max_list),
                   exist=torch.from_numpy(np.asarray(exist, np.int32)
                                          .copy()).to(device),
                   kv=torch.from_numpy(np.asarray(kv, np.int32).copy()
                                       ).to(device),
                   bits=None if sharded else shards[0],
                   list_voff=np.asarray(list_voff, np.int64),
                   device=device, sharded=sharded, devices=devs,
                   shard_bits=shards, **stats)


def dense_image(idx: KmaIndex, device: DeviceLike = None,
                mem_budget_bytes: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None,
                batch: int = DEFAULT_BATCH) -> DenseIndex:
    """The dense image on one device or, when its footprint is over one
    device's budget, sharded over ``devices`` if they are two or more
    (the JAX DenseScanner's fallback, scan_dense.py:723-741).
    ``devices`` None means every CUDA card when ``device`` is None too,
    else ``device`` alone.  Every other refusal raises
    NotImplementedError, as does the budget on fewer than two devices.
    The one-device image goes on ``device``, else on ``devices[0]``."""
    one = device if device is not None or not devices else devices[0]
    try:
        return DenseIndex.from_host(idx, one, mem_budget_bytes, batch=batch)
    except NotImplementedError as err:
        if "dense membership" not in str(err):
            raise
        if devices is None and device is not None:
            devices = [device]
        devs = resolve_devices(devices)
        if len(devs) < 2:
            raise
    didx = DenseIndex.from_host(idx, None, mem_budget_bytes, devices=devs,
                                batch=batch)
    print("# device scanner: dense membership sharded over %d devices "
          "('db' axis)" % len(devs), file=sys.stderr)
    return didx


def _strand_runs(codes, lengths, didx: DenseIndex, p: ScanParams,
                 starts=None):
    """Front half of the strand scan (kma_tpu scan_dense.py:348-409):
    windows, lookup, stride-k quick probe and run compaction.

    Returns dict of run_start/run_end/run_row/run_score [G, R] int32
    (dead slots BIG / -1 / 0 / 0, the JAX fills), n_runs [G] int32
    and run_ov [G] bool."""
    G, L = codes.shape
    k = p.k
    W = L - k + 1
    R = p.run_cap
    dev = codes.device
    kmers = batch_kmers(codes, k)
    valid = valid_windows(codes, lengths, k, starts)
    rows = lookup_voffsets(didx.exist, didx.kv, kmers, didx.size, 0,
                           didx.mega, -1)
    rows = torch.where(valid, rows, -1)
    hit = rows >= 0
    posW = torch.arange(W, dtype=torch.int64, device=dev)[None, :]

    if not p.exhaustive:
        seg_start = _segment_starts(codes)[:, :W]
        if starts is not None:
            seg_start = torch.maximum(seg_start, starts[:, None].long())
        probe = valid & (((posW - seg_start) % k) == 0)
        quick = torch.any(probe & hit, dim=-1)
        hit = hit & quick[:, None]
        rows = torch.where(hit, rows, -1)

    hit_pos = torch.where(hit, posW, -1)
    last_hit_le = torch.cummax(hit_pos, dim=1).values
    prev_hit = torch.cat([torch.full((G, 1), -1, dtype=torch.int64,
                                     device=dev), last_hit_le[:, :-1]],
                         dim=-1)
    has_prev = prev_hit >= 0
    rows_prev = torch.where(
        has_prev, torch.gather(rows, 1, prev_hit.clamp(min=0)), -1)
    same_run = hit & has_prev & (rows_prev == rows)
    new_run = hit & ~same_run
    gap = posW - prev_hit - 1
    trans = torch.where(same_run, _run_transition_score(gap, p), 0)

    n_runs = new_run.sum(dim=-1)
    run_ov = n_runs > R
    # 0-based run id of each hit window; windows past the cap (or not
    # hits) scatter into the dump column R
    rid = torch.cumsum(new_run.long(), dim=-1) - 1
    slot = torch.where(hit & (rid < R), rid, R)
    start_slot = torch.where(new_run, slot, R)
    i32 = torch.int32
    run_start = torch.full((G, R + 1), BIG, dtype=torch.int64, device=dev)
    run_start.scatter_(1, start_slot, posW.expand(G, W))
    run_row = torch.zeros((G, R + 1), dtype=torch.int64, device=dev)
    run_row.scatter_(1, start_slot, rows.long())
    run_end = torch.full((G, R + 1), -1, dtype=torch.int64, device=dev)
    run_end.scatter_reduce_(1, slot, posW.expand(G, W), reduce="amax")
    run_score = torch.zeros((G, R + 1), dtype=torch.int64, device=dev)
    run_score.scatter_add_(1, slot, trans.long())
    return dict(run_start=run_start[:, :R].to(i32).contiguous(),
                run_end=run_end[:, :R].to(i32).contiguous(),
                run_row=run_row[:, :R].to(i32).contiguous(),
                run_score=run_score[:, :R].to(i32).contiguous(),
                n_runs=n_runs.to(i32), run_ov=run_ov)


def _run_state(codes, lengths, didx: DenseIndex, p: ScanParams, rc_rows,
               starts=None):
    """Front half on the primary device, then the run-scoring kernel on
    every column shard with the run arrays copied to its device.
    Returns ([(score, first [G, T_s] int32 on the shard's device, first
    word w0)] a shard, run_ov [G])."""
    f = _strand_runs(codes, lengths, didx, p, starts)
    runs = (f["run_row"], f["run_start"], f["run_end"], f["run_score"],
            f["n_runs"], rc_rows.to(torch.int32).contiguous())
    shards = []
    for s, (dev, tab) in enumerate(zip(didx.devices, didx.shard_bits)):
        run_row, rstart, rend, rscore, n_runs, rc_i = (t.to(dev)
                                                       for t in runs)
        score, first = run_score_rows(tab, run_row, rstart, rend, rscore,
                                      n_runs, rc_i, p=p)
        didx.shard_calls[s] += 1
        shards.append((score, first, s * tab.shape[1]))
    return shards, f["run_ov"]


def _fused(p: ScanParams, t_pad: int) -> bool:
    """Whether (first, template id) fits one key below 2**24 (the JAX
    package's f32 top-k value)."""
    return (int(p.run_cap) + 1) * (t_pad + 1) < (1 << 24)


def _tie_key(sc, fi, inc, best, p: ScanParams, t_pad, w0: int,
             proxi_frac=None):
    """One shard's tie selection (savekmers.c:2750-2833 select) against
    the global ``best``: (n_best [n], the negated top-k key [n, T_s]
    int64, -BIG where not selected).  ``inc`` is ``fi < BIG`` when the
    caller has it, else None.

    Append order = (first-including run, template id).  The fused key
    first*(t_pad+1)+tid is unique, so a top-k over it cannot reorder
    ties; the unfused branch keys on first alone and is sorted later.
    The key is built in place: one [n, T_s] int64 tensor."""
    if inc is None:
        inc = fi < BIG
    if proxi_frac is None:
        sel = sc == best[:, None]
    else:
        thresh = (torch.tensor(proxi_frac, dtype=torch.float32)
                  * best.to(torch.float32)).to(torch.int32)
        sel = sc >= thresh[:, None]
    sel &= inc
    sel &= best[:, None] > 0
    n_best = sel.sum(dim=-1)
    key = fi.long()
    if _fused(p, t_pad):
        key.mul_(t_pad + 1).add_(torch.arange(
            32 * w0, 32 * w0 + fi.shape[1], dtype=torch.int64,
            device=fi.device))
    return n_best, key.neg_().masked_fill_(~sel, -BIG)


def _shard_ties(sc, fi, inc, best, p: ScanParams, t_pad, w0: int,
                proxi_frac=None):
    """(n_best [n], the top-k negated keys [n, k] and their template ids
    [n, k] int64) of one shard's ties, k = min(MB, the shard's
    columns)."""
    n_best, key = _tie_key(sc, fi, inc, best, p, t_pad, w0, proxi_frac)
    k = min(p.best_cap, t_pad, fi.shape[1])
    topv, idx = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    return n_best, topv, idx + 32 * w0 if w0 else idx


def _ties(shards, rows, best, p: ScanParams, t_pad, proxi_frac, dev):
    """Phase 2 of an epilogue: every shard selects its ties of ``rows``
    (None: every row) against the global ``best`` and takes its local
    top-k; the candidates meet on ``dev`` for one top-MB (``_merge_cands``).
    Returns (tids [n, MB] int32 in append order, n_best [n], tie_ov [n])."""
    n_best, topv, tids = None, [], []
    for sc, fi, w0, inc in shards:
        d = sc.device
        if rows is not None:
            r = rows.to(d)
            sc, fi, inc = sc[r], fi[r], None
        nb, tv, ti = _shard_ties(sc, fi, inc, best.to(d), p, t_pad, w0,
                                 proxi_frac)
        nb = nb.to(dev)
        n_best = nb if n_best is None else n_best + nb
        topv.append(tv.to(dev))
        tids.append(ti.to(dev))
    if len(shards) == 1:
        return _merge_cands(n_best, topv[0], tids[0], p, t_pad, 1)
    return _merge_cands(n_best, torch.cat(topv, dim=1),
                        torch.cat(tids, dim=1), p, t_pad, len(shards))


def _merge_cands(n_best, topv, tids, p: ScanParams, t_pad, n_shards: int):
    """The shards' candidates (their top-k negated keys and template ids
    side by side in shard order, [n, n_shards * k] int64) merged into one
    top-MB in append order: (tids [n, MB] int32, n_best, tie_ov [n])."""
    MB = min(p.best_cap, t_pad)
    if n_shards > 1:
        topv, order = torch.topk(topv, MB, dim=-1, largest=True,
                                 sorted=True)
        tids = torch.gather(tids, 1, order)
    cand_ok = topv > -BIG
    if _fused(p, t_pad):
        tids = torch.where(cand_ok, tids, 0)
    else:
        key2 = torch.where(cand_ok, -topv * (t_pad + 1) + tids, BIG)
        key2, order = torch.sort(key2, dim=-1, stable=True)
        tids = torch.where(key2 < BIG, torch.gather(tids, 1, order), 0)
    return tids.to(torch.int32), n_best, n_best > MB


def _clip_score(shards):
    """Each shard's (score, first, w0, included mask ``first < BIG``),
    its scores with excluded templates 0 and negatives clipped
    (savekmers.c:2750), in place."""
    out = []
    for sc, fi, w0 in shards:
        inc = fi < BIG
        sc.clamp_(min=0).masked_fill_(~inc, 0)
        out.append((sc, fi, w0, inc))
    return out


def _global_best(shards, dev):
    """Phase 1 of an epilogue: every shard's row maxima, reduced on
    ``dev``."""
    best = None
    for sc, *_ in shards:
        m = sc.max(dim=-1).values.to(dev)
        best = m if best is None else torch.maximum(best, m)
    return best.to(torch.int32)


def _strand_epilogue(shards, p: ScanParams, t_pad, dev, proxi_frac=None):
    """Best score + tie lists per strand row."""
    shards = _clip_score(shards)
    bestScore = _global_best(shards, dev)
    tids, n_best, tie_ov = _ties(shards, None, bestScore, p, t_pad,
                                 proxi_frac, dev)
    return bestScore, tids, n_best, tie_ov


def _pack_owner(n_out, flat_cap: int, B: int):
    """Owner row and in-row offset of every flat slot: a scatter of ones
    at each row's start offset (offsets >= flat_cap go to a dump slot,
    the JAX ``.at[].add(mode="drop")``) and a cumsum."""
    dev = n_out.device
    off = torch.cumsum(n_out, dim=0) - n_out
    total = n_out.sum()
    x = torch.arange(flat_cap, dtype=torch.int64, device=dev)
    starts = torch.zeros(flat_cap + 1, dtype=torch.int64, device=dev)
    starts.scatter_add_(0, off.clamp(max=flat_cap),
                        torch.ones_like(off))
    b = torch.clamp(torch.cumsum(starts[:flat_cap], dim=0) - 1, 0, B - 1)
    j = x - off[b]
    return x, b, j, total


def _merge_mode(bf, br, k):
    some = (bf > 0) | (br > 0)
    usable = (bf >= k) | (br >= k)
    mode = torch.where(some & usable,
                       torch.where(bf > br, 1, torch.where(bf < br, 2, 3)),
                       0)
    score = torch.where(mode == 2, br, bf)
    score = torch.where(mode == 3, -score, score) * (mode != 0)
    return mode, score


def _meta(score, mode, ov, n_out):
    return torch.stack([score.to(torch.int32),
                        (mode | (ov.long() << 2) | (n_out.long() << 3)
                         ).to(torch.int32)], dim=-1)


def _choose(bestScore, B: int, k: int):
    """The single-strand choice of tier 0 (savekmers.c:2766-2833) from
    the strand rows' global best: (mode, the signed score, the chosen
    strand's rows [B] int64, their best)."""
    bf, br = bestScore[:B], bestScore[B:]
    mode, out_score = _merge_mode(bf, br, k)
    iota = torch.arange(B, dtype=torch.int64, device=bestScore.device)
    rs = torch.where(mode == 2, iota + B, iota)
    return mode, out_score, rs, torch.where(mode == 2, br, bf)


def _merged_pack(tids, n_best, tie_ov, run_ov, mode, out_score, B: int,
                 p: ScanParams, t_pad, flat_cap, small_ids):
    """Pack the chosen strand's ties: equal-best reads (mode 3) come back
    flagged overflow for the dual-strand tier-1 rescan."""
    MB = min(p.best_cap, t_pad)
    ov = (run_ov[:B] | run_ov[B:] | (mode == 3)
          | torch.where(mode == 0, False, tie_ov))
    n_out = torch.where(ov | (mode == 0), 0, n_best)
    x, b, j, total = _pack_owner(n_out, flat_cap, B)
    ids = tids.reshape(-1)[b * MB + torch.clamp(j, 0, MB - 1)]
    dt = torch.int16 if small_ids else torch.int32
    flat = torch.where(x < total, ids, 0).to(dt)
    return _meta(out_score, mode, ov, n_out), flat


def _merged_epilogue(shards, run_ov, p: ScanParams, t_pad, B, flat_cap,
                     small_ids, proxi_frac=None):
    """Single-strand-choice epilogue (savekmers.c:2766-2833): the tie
    top-k runs on the chosen strand's rows only."""
    dev = run_ov.device
    shards = _clip_score(shards)
    mode, out_score, rs, chosen_best = _choose(_global_best(shards, dev), B,
                                               p.k)
    tids, n_best, tie_ov = _ties(shards, rs, chosen_best, p, t_pad,
                                 proxi_frac, dev)
    return _merged_pack(tids, n_best, tie_ov, run_ov, mode, out_score, B, p,
                        t_pad, flat_cap, small_ids)


def _emit_pack(bestScore, tids, n_best, run_ov, tie_ov, B, k, flat_cap,
               small_ids):
    """fw/rc merge decision + compact packing (savekmers.c:2766-2833).

    Returns meta [B, 2] int32 (col0 = signed rc_flag score; col1 =
    mode | overflow<<2 | n_out<<3) and flat [flat_cap] signed template
    ids (mode 3 appends rc ids negated)."""
    bf, br = bestScore[:B], bestScore[B:]
    tf, tr = tids[:B], tids[B:]
    nf, nr = n_best[:B], n_best[B:]
    MB = tf.shape[1]
    mode, score = _merge_mode(bf, br, k)
    # run overflow corrupts scores, so it always propagates; tie
    # overflow only truncates a list, so it matters only for the
    # strand(s) the merge decision emits
    tof, tor = tie_ov[:B], tie_ov[B:]
    ov = (run_ov[:B] | run_ov[B:]
          | torch.where(mode == 1, tof,
                        torch.where(mode == 2, tor,
                                    torch.where(mode == 3, tof | tor,
                                                False))))
    first = torch.where((mode == 2)[:, None], tr, tf)
    n1 = torch.where(ov, 0, torch.where(mode == 2, nr,
                                        torch.where(mode == 0, 0, nf)))
    n2 = torch.where(ov, 0, torch.where(mode == 3, nr, 0))
    n_out = n1 + n2
    x, b, j, total = _pack_owner(n_out, flat_cap, B)
    n1b = n1[b]
    idf = first.reshape(-1)[b * MB + torch.clamp(j, 0, MB - 1)]
    idr = tr.reshape(-1)[b * MB + torch.clamp(j - n1b, 0, MB - 1)]
    dt = torch.int16 if small_ids else torch.int32
    flat = torch.where(x < total, torch.where(j < n1b, idf, -idr), 0
                       ).to(dt)
    return _meta(score, mode, ov, n_out), flat


def _strands(codes, lengths):
    """Both strands of a forward batch codes [B, L]: (codes [2B, L], the
    lengths and window starts [2B] int64, reverse-complement rows [2B]
    bool).  The reverse complement is flipped and right-aligned in the
    padded buffer; ``starts`` bounds its windows."""
    B, L = codes.shape
    rc = torch.flip(torch.where(codes < 4, 3 - codes, codes), dims=[-1])
    lengths = lengths.to(torch.int64)
    return (torch.cat([codes, rc], dim=0),
            torch.cat([lengths, torch.full_like(lengths, L)]),
            torch.cat([torch.zeros_like(lengths), L - lengths]),
            torch.arange(2 * B, device=codes.device) >= B)


def dense_scan_device(codes, lengths, didx: DenseIndex, *, sparams,
                      flat_cap: int, small_ids: bool, proxi_frac=None,
                      merged: bool = False):
    """Dense scan of one FORWARD batch codes [B, L] uint8, lengths [B]
    int32 (tensors on the index's primary device).  The reverse complement is
    built on the device, flipped and right-aligned in the padded buffer
    (``starts`` bounds its windows); the scan uses only relative
    positions.  merged=True takes the single-strand-choice epilogue.
    Returns (meta [B, 2] int32, flat [flat_cap] int16|int32)."""
    p = ScanParams(*sparams)
    B = codes.shape[0]
    dev = codes.device
    codes2, lens2, starts2, rc_rows = _strands(codes, lengths)
    shards, run_ov = _run_state(codes2, lens2, didx, p, rc_rows, starts2)
    if merged:
        return _merged_epilogue(shards, run_ov, p, didx.t_pad, B, flat_cap,
                                small_ids, proxi_frac)
    bestScore, tids, n_best, tie_ov = _strand_epilogue(
        shards, p, didx.t_pad, dev, proxi_frac)
    return _emit_pack(bestScore, tids, n_best, run_ov, tie_ov, B, p.k,
                      flat_cap, small_ids)


class GraphKey(collections.namedtuple("GraphKey", (
        "sparams", "B", "flat_cap", "small_ids", "mega", "size",
        "max_probe", "t_pad", "n_lists", "proxi_frac", "merged", "L",
        "device"))):
    """A dense step graph's key (``graph_key``)."""

    __slots__ = ()

    @property
    def tier(self) -> int:
        return 0 if self.merged else 1     # tier 0 takes the merged epilogue


def graph_key(didx: DenseIndex, shape, statics: dict) -> GraphKey:
    """The key of a batch of ``shape`` (B, L) at ``statics`` (the keyword
    arguments of ``dense_scan_device``): the static arguments of the
    JAX jit of ``dense_scan_device`` (kma_tpu/mapping/scan_dense.py:
    565-568: sparams, B, flat_cap, small_ids, the image's mega, size,
    max_probe, t_pad and n_lists, proxi_frac, merged; its pallas_mode
    has no counterpart), L, which jit reads from the shape, and where
    the step runs: the device, or on a sharded image the layout the JAX
    mesh fixes (:151-162), each shard's device and membership words
    [w0, w1) (shard 0's device the primary)."""
    B, L = shape
    where = str(didx.device)
    if didx.sharded:
        w = [t.shape[1] for t in didx.shard_bits]
        where = tuple((str(dev), s * ws, (s + 1) * ws)
                      for s, (dev, ws) in enumerate(zip(didx.devices, w)))
    return GraphKey(statics["sparams"], int(B), statics["flat_cap"],
                    statics["small_ids"], didx.mega, didx.size,
                    didx.max_probe, didx.t_pad, didx.n_lists,
                    statics["proxi_frac"], statics["merged"], int(L),
                    where)


@dataclasses.dataclass
class _Graph:
    graph: object                  # torch.cuda.CUDAGraph
    codes: torch.Tensor            # static inputs: codes [B, L] uint8,
    lengths: torch.Tensor          # lengths [B] int32
    out: Tuple[torch.Tensor, ...]  # static outputs: meta, flat
    launches: Tuple[int, ...]      # launches it holds, by ``kernels``
    kernels: Tuple[Callable, ...] = ()

    def replay(self, codes, lengths):
        self.codes.copy_(codes)
        self.lengths.copy_(lengths)
        self.graph.replay()
        # a replay runs the kernel launches its graph holds
        _add(self.kernels, self.launches)
        return tuple(t.clone() for t in self.out)


def _add(kernels, launches, calls=None, shard=None) -> None:
    """Add ``launches`` (by kernel; with ``calls``, the last is shard
    ``shard``'s run-scoring calls) to the wrappers' counts."""
    for k, n in zip(kernels, launches):
        k.launches += n
    if calls is not None:
        calls[shard] += launches[-1]


def _pool_key(dev) -> str:
    """A card's key in ``StepGraphs.pools``: ``cuda:<index>`` whether the
    device names its index or not."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _capture_counted(capture, fn, args, pool, kernels, calls=None,
                     shard=None):
    """``capture(fn, args, pool)`` with the counts ``fn`` bumps in
    Python (the wrappers' ``launches``; with ``calls``, ``calls[shard]``,
    a shard's run-scoring calls): the warm-up calls' stay, the capture
    pass's are taken back, since it launched nothing.  Returns (graph,
    outputs, the counts one replay adds)."""
    def read():
        return tuple(k.launches for k in kernels) + (
            () if calls is None else (calls[shard],))

    held = []

    def counted(*a):
        n0 = read()
        out = fn(*a)
        held.append(tuple(n - m for n, m in zip(read(), n0)))
        return out

    graph, out = capture(counted, args, pool=pool)
    _add(kernels, tuple(-n for n in held[-1]), calls, shard)
    return graph, out, held[-1]


class _Arena:
    """Buffers that the graphs of every key share on a device, by name:
    the sharded plans' segment inputs and outputs and the batch's
    codes, which a batch's own segments consume before the next batch's
    run (replays run one at a time, each device's in order).  A key that
    needs more than a buffer holds takes a larger one; the keys captured
    before keep theirs."""

    def __init__(self):
        self.bufs: Dict[tuple, torch.Tensor] = {}

    def take(self, name: str, shape, dtype, device) -> torch.Tensor:
        n = math.prod(shape)
        k = (name, str(device), dtype)
        b = self.bufs.get(k)
        if b is None or b.numel() < n:
            b = self.bufs[k] = torch.empty(n, dtype=dtype, device=device)
        return b[:n].view(shape)

    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.bufs.values())


def _unpack_runs(runs, G: int, R: int):
    """(run_row, run_start, run_end, run_score [G, R], n_runs, rc_rows
    [G]) int32 views of a packed run buffer (``_plan_sizes``)."""
    GR = G * R
    rows = [runs[i * GR: (i + 1) * GR].view(G, R) for i in range(4)]
    return rows + [runs[4 * GR: 4 * GR + G], runs[4 * GR + G:]]


def _plan_sizes(B: int, R: int, n_db: int, kk: int, merged: bool):
    """Elements of a sharded plan's buffers at B reads, run cap R, n_db
    shards and kk candidates a shard's row: runs (4 [G, R] arrays, n_runs
    and rc_rows), the candidates a shard (n rows of n_best, kk keys, kk
    ids), n and G; the selection (merged: the chosen rows and their best;
    else the best of every strand row) and the row maxima take G."""
    G = 2 * B
    n = B if merged else G
    return dict(runs=4 * G * R + 2 * G, cands=n * (2 * kk + 1), n=n, G=G)


class ShardedStep:
    """``dense_scan_device`` on a sharded image as five segments, each a
    pure function of tensors on one device, split where the eager step's
    data crosses devices:

    1. the primary: both strands and the front half into a packed run
       buffer and ``run_ov``;
    2. each shard: ``run_score_rows`` on its columns, the clip, its row
       maxima (shard ``s``'s score, first and mask stay on its device);
    3. the primary: the global best of the maxima (tier 0: the strand
       choice, its rows and their best);
    4. each shard: its ties against that best and its local top-k;
    5. the primary: the top-MB merge and the pack.

    ``StepGraphs`` captures each segment into a graph on its own device
    (``capture``) and replays them in this order, with ``copy_`` into the
    next segment's inputs between (a cross-device ``copy_`` orders itself
    with CUDA events against both devices' current streams, and syncs no
    host).  Shard 0 sits on the primary and reads and writes the
    primary's buffers; every other shard takes copies, on one card as on
    four.  The inputs and outputs live in ``_Arena`` buffers: a key holds
    no tensor of its own."""

    def __init__(self, didx: DenseIndex, B: int, L: int, statics: dict):
        self.d, self.B, self.L = didx, B, L
        self.p = p = ScanParams(*statics["sparams"])
        self.flat_cap = statics["flat_cap"]
        self.small_ids = statics["small_ids"]
        self.proxi_frac = statics["proxi_frac"]
        self.merged = statics["merged"]
        self.R = p.run_cap
        self.kk = min(p.best_cap, didx.t_pad, didx.shard_bits[0].shape[1]
                      * 32)
        self.sz = _plan_sizes(B, self.R, len(didx.devices), self.kk,
                              self.merged)

    # -- the segments (pure functions of their tensors) ---------------------

    def front(self, codes, lengths, exist, kv, runs, run_ov):
        img = dataclasses.replace(self.d, exist=exist, kv=kv)
        codes2, lens2, starts2, rc_rows = _strands(codes, lengths)
        f = _strand_runs(codes2, lens2, img, self.p, starts2)
        torch.cat([f[k].reshape(-1) for k in (
            "run_row", "run_start", "run_end", "run_score", "n_runs")]
            + [rc_rows.to(torch.int32)], out=runs)
        run_ov.copy_(f["run_ov"])
        return runs, run_ov

    def score(self, s: int, runs, tab, rowmax):
        G = self.sz["G"]
        run_row, rstart, rend, rscore, n_runs, rc_i = _unpack_runs(
            runs, G, self.R)
        sc, fi = run_score_rows(tab, run_row, rstart, rend, rscore, n_runs,
                                rc_i, p=self.p)
        self.d.shard_calls[s] += 1
        (sc, fi, _, inc), = _clip_score([(sc, fi, 0)])
        torch.amax(sc, dim=-1, out=rowmax)
        return sc, fi, inc

    def best(self, maxima, sel, modes):
        best = maxima.amax(dim=0)
        if not self.merged:
            sel.copy_(best)
            return (sel,)
        B = self.B
        mode, out_score, rs, chosen = _choose(best, B, self.p.k)
        sel[:B].copy_(rs)
        sel[B:].copy_(chosen)
        modes[0].copy_(mode)
        modes[1].copy_(out_score)
        return sel, modes

    def ties(self, s: int, sc, fi, inc, sel, cands):
        if self.merged:
            B = self.B
            r = sel[:B].long()
            sc, fi, inc, best = sc[r], fi[r], None, sel[B:]
        else:
            best = sel
        nb, tv, ti = _shard_ties(sc, fi, inc, best, self.p, self.d.t_pad,
                                 s * self.d.shard_bits[s].shape[1],
                                 self.proxi_frac)
        kk = self.kk
        cands[:, 0].copy_(nb)
        cands[:, 1: kk + 1].copy_(tv)
        cands[:, kk + 1:].copy_(ti)
        return (cands,)

    def pack(self, cands, run_ov, sel, modes, meta, flat):
        n_db, n, kk = cands.shape[0], self.sz["n"], self.kk
        c = cands.long()
        n_best = c[:, :, 0].sum(dim=0)
        topv = c[:, :, 1: kk + 1].transpose(0, 1).reshape(n, n_db * kk)
        tids = c[:, :, kk + 1:].transpose(0, 1).reshape(n, n_db * kk)
        t_pad, p = self.d.t_pad, self.p
        tids, n_best, tie_ov = _merge_cands(n_best, topv, tids, p, t_pad,
                                            n_db)
        if self.merged:
            m, f = _merged_pack(tids, n_best, tie_ov, run_ov, modes[0],
                                modes[1], self.B, p, t_pad, self.flat_cap,
                                self.small_ids)
        else:
            m, f = _emit_pack(sel, tids, n_best, run_ov, tie_ov, self.B,
                              p.k, self.flat_cap, self.small_ids)
        meta.copy_(m)
        flat.copy_(f)
        return meta, flat

    # -- capture -------------------------------------------------------------

    def capture(self, capture, pools, arena: _Arena, kernels, codes,
                lengths) -> "_Plan":
        """Every segment captured in plan order (``capture``, each into
        its device's pool in ``pools``), the copies between them made
        once; the shards' score, first and mask are let go at the end
        (their blocks return to their pool, which another key's capture
        may reuse: a batch's own segments read them before the next
        batch's run)."""
        d, sz, B = self.d, self.sz, self.B
        prim, devs, n_db = d.device, d.devices, len(d.devices)
        i32 = torch.int32

        def take(name, shape, dtype=i32, dev=prim):
            return arena.take(name, shape, dtype, dev)

        def cap(fn, args, dev, s=None):
            """(graph, counts a replay adds), and the outputs apart: a
            segment's graph keeps none of its own."""
            g, out, n = _capture_counted(capture, fn, args,
                                         pools.get(_pool_key(dev)), kernels,
                                         None if s is None
                                         else d.shard_calls, s)
            return (g, n), out

        P = _Plan(self, kernels)
        P.codes = take("codes", tuple(codes.shape), torch.uint8)
        P.lengths = take("lengths", (B,))
        P.codes.copy_(codes)
        P.lengths.copy_(lengths)
        P.runs = take("runs", (sz["runs"],))
        P.run_ov = take("run_ov", (sz["G"],), torch.bool)
        P.maxima = take("maxima", (n_db, sz["G"]))
        P.sel = take("sel", (sz["G"],))
        P.modes = take("modes", (2, B), torch.int64)
        P.cands = take("cands", (n_db, sz["n"], 2 * self.kk + 1))
        dt = torch.int16 if self.small_ids else torch.int32
        P.meta = take("meta", (B, 2))
        P.flat = take("flat", (self.flat_cap,), dt)
        P.g_front, _ = cap(self.front, (P.codes, P.lengths, d.exist, d.kv,
                                        P.runs, P.run_ov), prim)
        held = []
        for s, (dev, tab) in enumerate(zip(devs, d.shard_bits)):
            # shard 0 is on the primary: it reads and writes the
            # primary's buffers; the others take copies
            sh = _PlanShard(
                runs=P.runs if s == 0 else take("runs%d" % s,
                                                (sz["runs"],), dev=dev),
                rowmax=P.maxima[s] if s == 0 else take(
                    "rowmax%d" % s, (sz["G"],), dev=dev),
                sel=P.sel if s == 0 else take("sel%d" % s, tuple(
                    P.sel.shape), dev=dev),
                cands=P.cands[s] if s == 0 else take(
                    "cands%d" % s, tuple(P.cands.shape[1:]), dev=dev))
            sh.copy_in(P.runs, sh.runs)
            sh.g_score, out = cap(functools.partial(self.score, s),
                                  (sh.runs, tab, sh.rowmax), dev, s)
            held.append(out)
            sh.copy_in(sh.rowmax, P.maxima[s])
            P.shards.append(sh)
        P.g_best, _ = cap(self.best, (P.maxima, P.sel, P.modes), prim)
        for s, (sh, (sc, fi, inc)) in enumerate(zip(P.shards, held)):
            sh.copy_in(P.sel, sh.sel)
            sh.g_ties, _ = cap(functools.partial(self.ties, s),
                               (sc, fi, inc, sh.sel, sh.cands), devs[s])
            sh.copy_in(sh.cands, P.cands[s])
        P.g_pack, _ = cap(self.pack, (P.cands, P.run_ov, P.sel, P.modes,
                                      P.meta, P.flat), prim)
        return P


@dataclasses.dataclass
class _PlanShard:
    """One shard's buffers in a captured plan, and its segments' (graph,
    counts a replay adds)."""

    runs: torch.Tensor
    rowmax: torch.Tensor
    sel: torch.Tensor
    cands: torch.Tensor
    g_score: tuple = None
    g_ties: tuple = None

    @staticmethod
    def copy_in(src, dst):
        if dst is not src:
            dst.copy_(src)


class _Plan:
    """A sharded step captured for one key: ``replay`` copies a batch in,
    replays the five segments in order with the copies between, and
    copies meta and flat out."""

    def __init__(self, step: ShardedStep, kernels):
        self.step, self.kernels = step, kernels
        self.shards: List[_PlanShard] = []

    def replay(self, codes, lengths):
        calls, kernels = self.step.d.shard_calls, self.kernels
        self.codes.copy_(codes)
        self.lengths.copy_(lengths)
        self.g_front[0].replay()
        for s, sh in enumerate(self.shards):
            sh.copy_in(self.runs, sh.runs)
            sh.g_score[0].replay()
            _add(kernels, sh.g_score[1], calls, s)
            sh.copy_in(sh.rowmax, self.maxima[s])
        self.g_best[0].replay()
        for s, sh in enumerate(self.shards):
            sh.copy_in(self.sel, sh.sel)
            sh.g_ties[0].replay()
            sh.copy_in(sh.cands, self.cands[s])
        self.g_pack[0].replay()
        return self.meta.clone(), self.flat.clone()


class StepGraphs:
    """The port's counterpart of the ``jax.jit`` cache of a scan step
    (the JAX ``dense_scan_device`` or ``fast_scan_device``, the chain
    op's ``_chain_lookup``): one CUDA graph of the step a key of static
    arguments (``graph_key``, ``scan_fast.fast_key``,
    ``chain_device.chain_key``).  The first batch of a key captures it
    (``entry.capture``: WARMUP eager calls, then the capture); every
    batch, that one too, copies its codes and lengths into the graph's
    static inputs, replays the graph, and copies its outputs out on the
    card at once, since the next replay of the key overwrites them (the
    scanner queues every batch of a request before the first sync, and
    the daemon dispatches request k+1 before it resolves request k).

    An image on a CUDA card holds one, which the scanners of every
    penalty set share: a dense image (its step reads the image's
    ``exist``, ``kv`` and ``bits``), the pair-stream image (``exist``,
    ``kv`` and ``values``; ``device_index.step_graphs``) and a dense
    image's chain op (``exist``, ``kv``; ``chain_device.chain_graphs``,
    sharing the dense graphs' pools).  ``tensors`` names what the step
    reads of the image: the graphs hold their addresses and live no
    longer than it.  A sharded image's step is a ``ShardedStep``: one
    graph a segment on the segment's device, captured, counted, replayed
    and evicted together as one key.

    Pool: the graphs of a device share one memory pool
    (``graph_pool_handle``; ``pools`` by device), so they hold one
    batch's intermediates at the largest key, not one each.  PyTorch
    calls a shared pool safe when its graphs replay in the order of
    their captures; here they replay in any order, which is safe because
    (1) replays run one at a time on one stream a device (the daemon's
    device work is serialised under its op lock, the chain op's too),
    so no two keys' intermediates are live at once, and (2) a graph's
    outputs are read only by the copies taken right after its own replay
    (a sharded key's, by its next segments, before the next batch's),
    so another graph whose intermediates reuse blocks freed in an earlier
    capture cannot clobber an output anyone reads.  The static inputs
    and the copies are allocated outside the pools.  At ``max_graphs``
    keys the least recently replayed is dropped (``evictions`` counts
    them).

    A capture that fails raises, and the caller's op faults: nothing runs
    eager in its place.  ``captures`` and ``replays`` count by key;
    ``capture_s`` holds each key's last capture time (host clock, the
    warm-up calls included).  ``kernels`` are the hand-written kernels'
    wrappers the step may launch (the dense step's ``run_score_rows``;
    none for the pair-stream and chain steps): the capture pass runs no
    launch, so a replay adds its graph's launches to each wrapper's
    count (and a sharded replay its shards' run-scoring calls to
    ``shard_calls``).  ``capture`` replaces ``entry.capture`` (the CPU
    tests' stand-in)."""

    def __init__(self, capture: Optional[Callable] = None,
                 tensors: Sequence[str] = ("exist", "kv", "bits"),
                 kernels: Sequence[Callable] = (run_score_rows,),
                 pools: Optional[dict] = None,
                 max_graphs: Optional[int] = None):
        self._capture = capture
        self.tensors = tuple(tensors)
        self.kernels = tuple(kernels)
        self.graphs: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        self.capture_s: Dict[tuple, float] = {}
        self.evictions = 0
        #: each card's pool handle, by ``_pool_key``; shareable
        self.pools = {} if pools is None else pools
        self.max_graphs = max_graphs
        self.arena = _Arena()

    @property
    def pool(self):
        """The first device's pool handle (None before a capture on a
        card)."""
        return next(iter(self.pools.values()), None)

    def run(self, key: tuple, step, codes: torch.Tensor,
            lengths: torch.Tensor, image):
        """The outputs of ``step`` (a pure function of codes, lengths
        and the image's ``tensors``: ``DenseScanner.step``,
        ``FastScanner.step``, ``chain_device.chain_step``; or a
        ``ShardedStep``) on this batch, replayed from the key's graphs."""
        g = self.graphs.get(key)
        if g is None:
            g = self._capture_key(key, step, codes, lengths, image)
        self.graphs.move_to_end(key)
        out = g.replay(codes, lengths)
        self.replays[key] += 1
        return out

    def _capture_key(self, key, step, codes, lengths, image):
        capture = self._capture
        if capture is None:
            from ..entry import capture  # entry.py imports this module
        devs = getattr(image, "devices", None) or (codes.device,)
        for dev in devs:
            if dev.type == "cuda" and _pool_key(dev) not in self.pools:
                with torch.cuda.device(dev):
                    self.pools[_pool_key(dev)] = \
                        torch.cuda.graph_pool_handle()
        cap = MAX_GRAPHS if self.max_graphs is None else self.max_graphs
        while len(self.graphs) >= cap:
            self.graphs.popitem(last=False)
            self.evictions += 1
        t0 = time.perf_counter()
        if isinstance(step, ShardedStep):
            g = step.capture(capture, self.pools, self.arena, self.kernels,
                             codes, lengths)
        else:
            args = (codes.clone(), lengths.clone(),
                    *(getattr(image, t) for t in self.tensors))
            graph, out, launches = _capture_counted(
                capture, step, args,
                self.pools.get(_pool_key(codes.device)), self.kernels)
            g = _Graph(graph, args[0], args[1], tuple(out), launches,
                       self.kernels)
        self.capture_s[key] = time.perf_counter() - t0
        self.graphs[key] = g
        self.captures[key] += 1
        return g

    def pool_bytes(self) -> int:
        """Bytes the graphs' pools hold on the cards (the segments
        ``torch.cuda.memory_snapshot`` gives the pools)."""
        if not self.pools:
            return 0
        pids = {tuple(p) for p in self.pools.values()}
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) in pids)


class DenseScanner:
    """Production -1t1 scanner: dense device scan with host fallback.

    scan_reads() takes a read set and returns per read (rc_flag score,
    mode, templates) with overflow reads marked for the host scanner.
    All batches are dispatched before the first device sync."""

    TIERS = TIERS  # (run_cap, best_cap) per tier

    def __init__(self, idx: KmaIndex, rewards, exhaustive: bool = False,
                 proxi_frac: Optional[float] = None, batch: int = 4096,
                 flat_headroom: int = FLAT_HEADROOM,
                 mem_budget_bytes: int = None,
                 didx: Optional[DenseIndex] = None,
                 device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        # a prebuilt image may be shared across scanner configs (the
        # devserve daemon serves one image to many penalty sets); a DB
        # over one device's budget is sharded over ``devices``
        self.didx = didx if didx is not None \
            else dense_image(idx, device, mem_budget_bytes, devices, batch)
        self.device = self.didx.device
        self.rewards = rewards
        self.exhaustive = exhaustive
        self.proxi_frac = proxi_frac
        self.batch = batch
        # per-read tie-id headroom of the flat buffer (ids/read); reads
        # past it are retried through the wide tier
        self.flat_headroom = flat_headroom
        self.small_ids = self.didx.db_size < (1 << 15)
        self._sp_cache: dict = {}
        #: scan statistics: tier-0 batches dispatched, reads rescanned
        #: by the wide tier
        self.tier0_batches = 0
        self.wide_reads = 0

    def _sparams(self, L: int, tier: int):
        """ScanParams tuple for a padded read length; run_cap is clamped
        to the most runs a read of that length can have."""
        ck = (L, tier)
        if ck not in self._sp_cache:
            d = self.didx
            rc_, bc_ = self.TIERS[tier]
            W = L - d.kmersize + 1
            rc_ = max(1, min(rc_, W))
            self._sp_cache[ck] = tuple(dataclasses.astuple(ScanParams(
                k=d.kmersize, mlen=d.mlen, M=self.rewards.M,
                MM=self.rewards.MM, U=self.rewards.U, W1=self.rewards.W1,
                max_list=d.max_list, exhaustive=self.exhaustive,
                max_probe=d.max_probe, run_cap=rc_, pair_cap=0,
                best_cap=bc_, small_ids=self.small_ids)))
        return self._sp_cache[ck]

    def _statics(self, L: int, tier: int, flat_cap: int) -> dict:
        """``dense_scan_device``'s keyword arguments for a batch padded
        to L at ``tier``."""
        return dict(sparams=self._sparams(L, tier), flat_cap=flat_cap,
                    small_ids=self.small_ids, proxi_frac=self.proxi_frac,
                    merged=tier == 0)

    def step(self, L: int, tier: int, flat_cap: int) -> Callable:
        """``dense_scan_device`` of a batch padded to L at ``tier`` as a
        pure function of (codes, lengths, exist, kv, bits), on the
        tensors' own device: what a step graph captures
        (``entry.dense_step`` gives the same function)."""
        d, statics = self.didx, self._statics(L, tier, flat_cap)

        def fn(codes, lengths, exist, kv, bits):
            img = dataclasses.replace(d, exist=exist, kv=kv, bits=bits,
                                      device=bits.device, sharded=False,
                                      devices=(bits.device,),
                                      shard_bits=(bits,), shard_calls=[0])
            return dense_scan_device(codes, lengths, img, **statics)

        return fn

    def sharded_step(self, B: int, L: int, tier: int,
                     flat_cap: int) -> ShardedStep:
        """``dense_scan_device`` of a [B, L] batch at ``tier`` on the
        sharded image as its five segments: what its step graphs
        capture."""
        return ShardedStep(self.didx, B, L, self._statics(L, tier, flat_cap))

    def _call(self, codes_t, lens_t, tier: int, flat_cap: int):
        """One batch: replayed from the image's step graphs when it has
        them (a sharded image's as a ``ShardedStep``), else eager."""
        B, L = codes_t.shape
        statics = self._statics(L, tier, flat_cap)
        d, graphs = self.didx, self.didx.graphs
        if graphs is None:
            return dense_scan_device(codes_t, lens_t, d, **statics)
        step = self.sharded_step(B, L, tier, flat_cap) if d.sharded \
            else self.step(L, tier, flat_cap)
        return graphs.run(graph_key(d, codes_t.shape, statics), step,
                          codes_t, lens_t, d)

    def scan_reads(self, codes: np.ndarray, lengths: np.ndarray):
        """Returns (scores i32 [N], modes u8 [N], tid_lists: list of
        int32 arrays, overflow bool [N]).  mode 0=unmapped 1=fw 2=rc
        3=merged (tids = fw ++ -rc)."""
        return self.scan_resolve(self.scan_dispatch(codes, lengths))

    def scan_dispatch(self, codes: np.ndarray, lengths: np.ndarray):
        """Queue the device work for a read set without syncing; returns
        a handle for scan_resolve (the daemon overlaps one request's
        device work with its neighbours' host work).  Reads past
        FOOTPRINT_READ_PAD go in batches of fewer rows (batch_rows)."""
        Bt = batch_rows(self.batch, codes.shape[1], self.didx.kmersize)
        flat_cap = self.flat_headroom * Bt
        futs = dispatch_tier0(self._call, codes, lengths, Bt, flat_cap,
                              self.device)
        self.tier0_batches += len(futs)
        return codes, lengths, futs, flat_cap, Bt

    def scan_resolve(self, handle):
        """Sync + post-process a scan_dispatch handle."""
        codes, lengths, futs, flat_cap, Bt = handle
        N = codes.shape[0]
        with tracing.span(tracing.DEVICE_WAIT):
            outs = [(m.cpu().numpy(), f.cpu().numpy()) for m, f in futs]

        scores = np.zeros(N, np.int32)
        modes = np.zeros(N, np.uint8)
        over = np.zeros(N, bool)
        tid_lists: list = [None] * N
        retry = []
        for bi, (meta, flat) in enumerate(outs):
            off = bi * Bt
            n = min(Bt, N - off)
            meta = meta[:n]
            flat = np.asarray(flat, dtype=np.int32)
            score, packedm = meta[:, 0], meta[:, 1]
            mode = packedm & 3
            ov = (packedm >> 2) & 1
            n_out = packedm >> 3
            offs = np.cumsum(n_out) - n_out
            scores[off: off + n] = score
            modes[off: off + n] = mode
            over[off: off + n] = ov.astype(bool)
            # reads whose slice spilled past flat_cap are retried
            # through the wide tier
            spilled = offs + n_out > flat_cap
            if spilled.any():
                retry.extend(off + np.flatnonzero(spilled))
            want = ((mode != 0) & (ov == 0) & ~spilled).tolist()
            o0 = offs.tolist()
            o1 = (offs + n_out).tolist()
            for i in range(n):
                if want[i]:
                    tid_lists[off + i] = flat[o0[i]: o1[i]]
        retry.extend(np.flatnonzero(over))
        if retry:
            retry = np.unique(np.asarray(retry, dtype=np.int64))
            self.wide_reads += len(retry)
            self._rescan_wide(codes, lengths, retry, scores, modes,
                              tid_lists, over)
        return scores, modes, tid_lists, over

    def _wide(self, codes, lengths, sel):
        return wide_chunks(self._call, codes, lengths, sel,
                           min(self.TIERS[1][1], self.didx.t_pad),
                           self.device, batch_rows(WIDE_ROWS, codes.shape[1],
                                                   self.didx.kmersize))

    def _rescan_wide(self, codes, lengths, sel, scores, modes, tid_lists,
                     over):
        """Tier-2 pass over the overflow tail on compacted sub-batches."""
        for s, meta, ids, n_out in self._wide(codes, lengths, sel):
            mode = meta[:, 1] & 3
            ov = ((meta[:, 1] >> 2) & 1).astype(bool)
            offs = np.cumsum(n_out) - n_out
            scores[s] = meta[:, 0]
            modes[s] = mode
            over[s] = ov
            for i, ri in enumerate(s):
                tid_lists[ri] = (ids[offs[i]: offs[i] + n_out[i]]
                                 if mode[i] and not ov[i] else None)
