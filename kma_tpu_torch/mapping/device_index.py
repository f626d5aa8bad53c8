"""Device k-mer index and lookup helpers (port of
kma_tpu/mapping/device_index.py).

Host numpy helpers (``murmur32_np``, ``_cuckoo_build``) are copied from
the JAX module, which imports jax at module level.  The tensor helpers
do their k-mer, murmur and complement bit math in ``int64`` with
``& 0xFFFFFFFF`` masks: torch implements neither ``<<`` nor ``>>`` on
``uint32`` on the CPU.  A k-mer (k <= 16) therefore lives in an int64
in ``[0, 2**32)``; ``kv[:, 0]`` holds the uint32 key viewed as int32,
so key comparisons go through ``as_i32``.

``DeviceIndex`` is the pair-stream scanner's image: the hash payload is
the values OFFSET of a k-mer's template list, and ``values`` holds the
flat ``[count, t1..tn]`` lists as on disk, so its size follows the DB's
k-mer count and not lists x templates as the dense membership table's
does.  On a CUDA card the image holds the pair-stream step's graphs
(``step_graphs``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..index.format import KmaIndex

if TYPE_CHECKING:
    from .scan_dense import StepGraphs

MURMUR_SEED = np.uint32(3323198485 & 0xFFFFFFFF)
MURMUR_SEED2 = np.uint32(0x9747B28C)
_M32 = 0xFFFFFFFF
# the open table's murmur spread keeps its load at or below 2**-2
_OPEN_LOAD_SHIFT = 2


def murmur32_np(x, seed=MURMUR_SEED) -> np.ndarray:
    v = ((np.asarray(x, dtype=np.uint64) ^ np.uint64(seed))
         * np.uint64(0x5BD1E995)) & np.uint64(0xFFFFFFFF)
    v = v.astype(np.uint32)
    return v ^ (v >> np.uint32(15))


def _cuckoo_tsize(n: int) -> int:
    """One side's slots of the cuckoo table for n keys (>= 1.3n)."""
    tsize = 1 << 16
    while tsize * 10 < n * 13:
        tsize <<= 1
    return tsize


def _cuckoo_build(keys: np.ndarray, voffs: np.ndarray, n: int,
                  max_rounds: int = 512):
    """Two-table cuckoo placement: every key lives at murmur(seed1) in
    table 0 or murmur(seed2) in table 1, so a lookup is exactly two
    8-byte gathers.

    Returns (kv[2*tsize, 2] i32, tsize) or None if the random walk
    fails.  Empty slots are (0, -1); hits require a non-negative value.
    """
    tsize = _cuckoo_tsize(n)
    mask = np.uint32(tsize - 1)
    tab_k = np.zeros(2 * tsize, dtype=np.int64)
    tab_v = np.full(2 * tsize, -1, dtype=np.int64)
    pk = keys.astype(np.int64)
    pv = voffs.astype(np.int64)
    ps = np.zeros(n, dtype=np.int8)
    for _ in range(max_rounds):
        if len(pk) == 0:
            break
        b = np.where(ps == 0,
                     murmur32_np(pk.astype(np.uint32)) & mask,
                     (murmur32_np(pk.astype(np.uint32), MURMUR_SEED2)
                      & mask) + np.uint32(tsize)).astype(np.int64)
        claim = np.full(2 * tsize, -1, dtype=np.int64)
        idxs = np.arange(len(pk))
        claim[b] = idxs
        win = claim[b] == idxs
        wb = b[win]
        old_k = tab_k[wb].copy()
        old_v = tab_v[wb].copy()
        tab_k[wb] = pk[win]
        tab_v[wb] = pv[win]
        occ = old_v != -1
        pk = np.concatenate([pk[~win], old_k[occ]])
        pv = np.concatenate([pv[~win], old_v[occ]])
        # losers flip sides (same-side losers would deadlock); evictees
        # move to their other table
        ps = np.concatenate([(1 - ps[~win]).astype(np.int8),
                             (wb[occ] < tsize).astype(np.int8)])
    if len(pk):
        return None
    kv = np.empty((2 * tsize, 2), dtype=np.int32)
    kv[:, 0] = (tab_k & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    kv[:, 1] = tab_v.astype(np.int32)
    return kv, tsize


@dataclasses.dataclass
class DeviceIndex:
    """Tensors of one frozen DB for the pair-stream scanner, in one of
    three layouts: megaMap direct addressing (``exist[kmer]`` is the
    values offset), the two-table cuckoo (``max_probe == 0``, ``kv``
    holds both halves) or, when the cuckoo walk fails, the open murmur
    table (``exist[bucket]`` is the bucket's first ``kv`` record and a
    lookup walks up to ``max_probe`` records).

    On a CUDA card it holds ``graphs``, the pair-stream step's graphs
    (``step_graphs``), which the scanners of every penalty set share;
    on the CPU none (its scans run eager)."""

    kmersize: int
    mlen: int
    flag: int
    db_size: int
    mega: bool
    size: int                 # table size (2^b), cuckoo half or mega mask+1
    null_index: int
    exist: torch.Tensor       # int32: record index, or megaMap values offset
    kv: torch.Tensor          # int32 [n_pad, 2]: (key, values offset)
    values: torch.Tensor      # int32 flat [v_index] (counts + ids, as disk)
    max_list: int             # most templates of one k-mer
    max_probe: int = 1        # 0 = cuckoo; else the longest bucket group
    device: torch.device = torch.device("cpu")
    graphs: Optional[StepGraphs] = None

    def __post_init__(self):
        if self.graphs is None and self.device.type == "cuda":
            self.graphs = step_graphs()

    @classmethod
    def from_host(cls, idx: KmaIndex,
                  device: DeviceLike = None) -> "DeviceIndex":
        """Build the image from a loaded index (the JAX package's
        ``DeviceIndex.from_host``, array for array)."""
        device = resolve(device)
        if idx.mlen > 16 or idx.v_index >= 1 << 31 or idx.n >= 1 << 31:
            raise NotImplementedError(
                "device index requires mlen<=16 and 31-bit offsets")
        if idx.flag & 3:
            raise NotImplementedError(
                "cmer (-m/-hc) DBs use the host scanner")
        values = np.asarray(idx.values, dtype=np.int32)
        common = dict(kmersize=idx.kmersize, mlen=idx.mlen, flag=idx.flag,
                      db_size=idx.db_size, values=values)
        if idx.mega:
            offs = idx.exist[idx.exist != idx.null_index].astype(np.int64)
            max_list = int(values[offs].max()) if len(offs) else 0
            return cls.from_jax_arrays(
                device, mega=True, size=idx.size,
                null_index=idx.null_index,
                exist=idx.exist.astype(np.int32),
                kv=np.zeros((1, 2), np.int32), max_list=max_list,
                max_probe=1, **common)

        keys = idx.key_index[: idx.n].astype(np.uint32)
        voffs = idx.value_index.astype(np.int64)
        max_list = int(values[voffs].max()) if idx.n else 0
        ck = _cuckoo_build(keys, voffs, int(idx.n)) if idx.n else None
        if ck is not None:
            kv, tsize = ck
            return cls.from_jax_arrays(
                device, mega=False, size=tsize, null_index=-1,
                exist=np.zeros(1, np.int32), kv=kv, max_list=max_list,
                max_probe=0, **common)

        # open table, murmur-spread
        dsize = 1 << 20
        while dsize < idx.n << _OPEN_LOAD_SHIFT:
            dsize <<= 1
        buckets = murmur32_np(keys) & np.uint32(dsize - 1)
        order = np.argsort(buckets, kind="stable")
        sbuckets = buckets[order].astype(np.int64)
        exist = np.full(dsize, -1, dtype=np.int32)
        firsts = np.ones(idx.n, dtype=bool)
        firsts[1:] = sbuckets[1:] != sbuckets[:-1]
        exist[sbuckets[firsts]] = np.flatnonzero(firsts)
        counts = np.diff(np.concatenate([np.flatnonzero(firsts), [idx.n]]))
        max_probe = int(counts.max()) if idx.n else 1
        kv = np.empty((idx.n + max_probe, 2), dtype=np.int32)
        kv[: idx.n, 0] = keys[order].view(np.int32)
        kv[: idx.n, 1] = voffs[order].astype(np.int32)
        # sentinel pad: its key hashes OUTSIDE the last group's bucket,
        # so the final group's overrun probe stops there and can never
        # match a query k-mer of that bucket
        last_bucket = int(sbuckets[-1]) if idx.n else 0
        s = 0
        while int(murmur32_np(np.uint32(s)) & np.uint32(dsize - 1)) \
                == last_bucket:
            s += 1
        kv[idx.n:, 0] = np.int32(s)
        kv[idx.n:, 1] = np.int32(-1)
        return cls.from_jax_arrays(
            device, mega=False, size=dsize, null_index=-1, exist=exist,
            kv=kv, max_list=max_list, max_probe=max_probe, **common)

    @classmethod
    def from_jax_arrays(cls, device: DeviceLike, *, exist, kv, values,
                        kmersize, mlen, flag, db_size, mega, size,
                        null_index, max_list, max_probe) -> "DeviceIndex":
        """Carry an image across from numpy arrays: the JAX
        DeviceIndex's ``exist``, ``kv`` and ``values`` plus its
        scalars."""
        device = resolve(device)

        def t(a):
            return torch.from_numpy(np.array(a, np.int32)).to(device)

        return cls(kmersize=int(kmersize), mlen=int(mlen), flag=int(flag),
                   db_size=int(db_size), mega=bool(mega), size=int(size),
                   null_index=int(null_index), exist=t(exist), kv=t(kv),
                   values=t(values), max_list=int(max_list),
                   max_probe=int(max_probe), device=device)


def step_graphs(capture: Optional[Callable] = None):
    """A graph cache for the pair-stream step (``scan_dense.StepGraphs``
    of a step that reads the image's ``exist``, ``kv`` and ``values`` and
    launches no hand-written kernel); ``capture`` as there."""
    from .scan_dense import StepGraphs   # scan_dense imports this module
    return StepGraphs(capture, tensors=("exist", "kv", "values"),
                      kernels=())


def lookup_voffsets(exist, kv, kmers, size: int, max_probe: int,
                    mega: bool, null_index: int) -> torch.Tensor:
    """int32 payload per k-mer (kmers int64 in [0, 2**32)) or -1:
    hashMap_getGlobal over the three device layouts.  The pair-stream
    image's payload is the values offset; the dense image's cuckoo and
    mega tables hold a list id under the same lookup (``null_index``
    -1)."""
    if mega:
        off = exist[kmers & (size - 1)]
        return torch.where(off == null_index, -1, off)
    mask = size - 1
    km = as_i32(kmers)
    if max_probe == 0:
        # cuckoo: key at murmur(seed1) in half 0 or murmur(seed2) in
        # half 1; empty slots carry -1
        e1 = kv[murmur32(kmers) & mask]
        e2 = kv[(murmur32(kmers, MURMUR_SEED2) & mask) + size]
        return torch.where((e1[..., 0] == km) & (e1[..., 1] >= 0),
                           e1[..., 1],
                           torch.where((e2[..., 0] == km) & (e2[..., 1] >= 0),
                                       e2[..., 1], -1))
    bucket = murmur32(kmers) & mask
    pos0 = exist[bucket].long()
    found = torch.full_like(kmers, -1)
    done = pos0 < 0
    pos0 = torch.where(done, 0, pos0)
    keys = kv[:, 0]
    # unrolled walk of the bucket's group; a record hashing to another
    # bucket ends it
    for step in range(max_probe):
        pos = pos0 + step
        key = keys[pos]
        hit = ~done & (key == km)
        found = torch.where(hit, pos, found)
        if step + 1 < max_probe:
            same = (murmur32(key.long() & _M32) & mask) == bucket
            done = done | hit | ~same
    ok = found >= 0
    return torch.where(ok, kv[:, 1][torch.where(ok, found, 0)], -1)


def murmur32(x: torch.Tensor, seed=MURMUR_SEED) -> torch.Tensor:
    """murmur32 of int64 values in [0, 2**32); result in the same range.
    (x ^ seed) < 2**32 and the multiplier < 2**31, so the product fits
    int64 before the mask."""
    v = ((x ^ int(seed)) * 0x5BD1E995) & _M32
    return v ^ (v >> 15)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> the same 32 bits viewed as int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def batch_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Rolling k-mers over a [B, L] uint8 batch (N counts as A; callers
    mask N windows); returns [B, L-k+1] int64 (k <= 16)."""
    c = torch.where(codes == 4, 0, codes.to(torch.int64))
    W = codes.shape[-1] - k + 1
    out = c[..., 0:W] << (2 * (k - 1))
    for j in range(1, k):
        out = out + (c[..., j: W + j] << (2 * (k - 1 - j)))
    return out


def valid_windows(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                  starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, L-k+1] True where the window has no N and fits the read.

    ``starts`` ([B], optional) bounds windows from the left: rows that
    hold a right-aligned read (the device-side reverse complement)
    pass starts = L - len and lengths = L."""
    cs = torch.cumsum((codes == 4).to(torch.int32), dim=-1)
    L = codes.shape[-1]
    width = L - k + 1
    cs0 = torch.nn.functional.pad(cs, (1, 0))
    n_in_window = cs[..., k - 1:] - cs0[..., :width]
    pos = torch.arange(width, device=codes.device)
    fits = pos[None, :] + k <= lengths[:, None]
    if starts is not None:
        fits = fits & (pos[None, :] >= starts[:, None])
    return (n_in_window == 0) & fits
