"""The benchmark's index writer: the default path of ``kma index`` (k 16,
no minimizer, no homopolymer compression, no ORF gate, no sparse
prefix), frozen here so that no run of the benchmark starts the JAX
package's CLI.

A copy of the default path of kma_tpu/index/build.py (``build_index``
with its in-memory ``KmerSpill``, ``freeze``) and of format.py's dumps,
rewritten to take every template's k-mers at once with NumPy.  The
files it writes (``.comp.b``, ``.length.b``, ``.name``, ``.seq.b``)
are the ones the daemon and ``native/kma_cli`` read, byte for byte
those of ``python -m kma_tpu index -i FASTA -o PREFIX``
(``kmabench/tests/test_kmabench_index.py`` holds them so).  Identical
template lists are deduplicated by ``kio_dedup_values`` of the native
host library ``native/libkma_io.so`` (``kma_tpu_torch/native_build.py``
builds it), as the JAX package's writer does.

    write_index(names, codes, offsets, prefix)

``codes`` is every template's 2-bit codes (0-3) end to end, template
``i`` at ``codes[offsets[i]:offsets[i + 1]]``.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Sequence

import numpy as np

K = 16
U32MAX = 0xFFFFFFFF
U16MAX = 0xFFFF
#: bits of a global k-mer position in the sort key (k-mer << POS_BITS)
POS_BITS = 31

_TO2BIT = np.full(256, 8, np.uint8)
for _c, _v in zip(b"ACGTUacgtuNn", (0, 1, 2, 3, 3, 0, 1, 2, 3, 3, 4, 4)):
    _TO2BIT[_c] = _v


def read_fasta(path: str):
    """(names, codes, offsets) of a FASTA of A/C/G/T sequences, as
    ``write_index`` takes them (names without the ``>``)."""
    names: List[bytes] = []
    parts: List[np.ndarray] = []
    with open(path, "rb") as f:
        chunks: List[bytes] = []
        for line in f:
            if line.startswith(b">"):
                if names:
                    parts.append(_codes(chunks))
                names.append(line[1:].rstrip())
                chunks = []
            else:
                chunks.append(line)
        if names:
            parts.append(_codes(chunks))
    lens = np.array([len(p) for p in parts], np.int64)
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return names, np.concatenate(parts) if parts else np.zeros(0, np.uint8), \
        offsets


def _codes(chunks) -> np.ndarray:
    c = _TO2BIT[np.frombuffer(b"".join(chunks), np.uint8)]
    c = c[c < 8]
    if (c == 4).any():
        raise ValueError("the benchmark's writer takes no N in a template")
    return c


def _io_lib() -> ctypes.CDLL:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "libkma_io.so")
    lib = ctypes.CDLL(path)
    lib.kio_dedup_values.restype = ctypes.c_longlong
    lib.kio_dedup_values.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _pack_2bit(codes: np.ndarray) -> np.ndarray:
    """compDNA: 32 codes a u64 word, MSB first (compdna.c:99-127)."""
    n = len(codes)
    words = (n >> 5) + (1 if n & 31 else 0)
    padded = np.zeros(words * 32, np.uint64)
    padded[:n] = codes
    shifts = np.uint64(62) - np.uint64(2) * np.arange(32, dtype=np.uint64)
    return (padded.reshape(words, 32) << shifts).sum(axis=1,
                                                     dtype=np.uint64)


def _write_seq(path: str, codes: np.ndarray, offsets: np.ndarray) -> None:
    """.seq.b: ((len >> 5) + 1) words a template, the last one, where
    len % 32 == 0, holding what the reference's reused pack buffer held
    (updateAnnots, updateindex.c:172; makeindex.c:219-222)."""
    qseq_cap = 1024
    buf = np.zeros(1024 >> 5, np.uint64)
    with open(path, "wb") as f:
        for i in range(len(offsets) - 1):
            c = codes[offsets[i]: offsets[i + 1]]
            n = len(c)
            while n >= qseq_cap:
                qseq_cap <<= 1
            if n >= len(buf) * 32:
                sz = qseq_cap if qseq_cap % 32 == 0 \
                    else ((qseq_cap >> 5) + 1) << 5
                buf = np.zeros(sz >> 5, np.uint64)
            packed = _pack_2bit(c)
            buf[: len(packed)] = packed
            buf[: (n >> 5) + 1].astype("<u8").tofile(f)


def _kmer_lists(codes: np.ndarray, offsets: np.ndarray):
    """Every distinct k-mer in first-seen order, with the templates
    (1-based, ascending) that hold it: (kmers u64 [n], offs i64 [n + 1],
    flat u32)."""
    total = len(codes)
    if total >= 1 << POS_BITS:
        raise ValueError("the DB passes the writer's %d-bit positions"
                         % POS_BITS)
    c = codes.astype(np.uint64)
    n = max(total - K + 1, 0)
    kmer = np.zeros(n, np.uint64)
    for j in range(K):
        kmer <<= np.uint64(2)
        kmer |= c[j: j + n]
    del c
    # a window is valid when it lies inside one template
    tid = np.zeros(total, np.uint32)
    tid[offsets[1:-1]] = 1
    tid = np.cumsum(tid, dtype=np.uint32)
    pos = np.arange(n, dtype=np.int64)
    ends = offsets[1:][tid[:n]]
    ok = pos + K <= ends
    key = (kmer[ok] << np.uint64(POS_BITS)) | pos[ok].astype(np.uint64)
    del kmer, ends, ok
    key.sort()
    sk = key >> np.uint64(POS_BITS)
    sp = (key & np.uint64((1 << POS_BITS) - 1)).astype(np.int64)
    del key
    st = tid[sp] + np.uint32(1)
    # a template's repeats of a k-mer are adjacent after the sort
    keep = np.ones(len(sk), bool)
    keep[1:] = (sk[1:] != sk[:-1]) | (st[1:] != st[:-1])
    sk, sp, st = sk[keep], sp[keep], st[keep]
    firsts = np.ones(len(sk), bool)
    firsts[1:] = sk[1:] != sk[:-1]
    gidx = np.flatnonzero(firsts)
    counts = np.diff(np.append(gidx, len(sk)))
    fs = np.argsort(sp[gidx], kind="stable")
    kmers = sk[gidx][fs]
    counts = counts[fs]
    offs = np.zeros(len(kmers) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    within = np.arange(len(sk), dtype=np.int64) - np.repeat(offs[:-1],
                                                            counts)
    flat = st[np.repeat(gidx[fs], counts) + within]
    return kmers, offs, np.ascontiguousarray(flat, np.uint32)


def _freeze(kmers, offs, flat):
    """compressKMA_DB's hash map (compress.c:83-614) on the chained
    table: (size, exist, values, key_index, value_index)."""
    n = len(kmers)
    size = 1 << 20
    while size < n:
        size <<= 1
    if size >= 1 << (2 * K):
        raise ValueError("a mega map: not the default path at k 16")
    order = np.argsort(kmers & np.uint64(size - 1), kind="stable")
    v_off = np.empty(n, np.int64)
    out = np.empty(len(flat) + n, np.uint32)
    order = np.ascontiguousarray(order, np.int64)
    v_index = _io_lib().kio_dedup_values(
        offs.ctypes.data, flat.ctypes.data, order.ctypes.data, n,
        v_off.ctypes.data, out.ctypes.data)
    values = out[:v_index].copy()
    buckets = kmers & np.uint64(size - 1)
    grp = np.argsort(buckets, kind="stable")
    key_index = np.empty(n + 1, np.uint64)
    key_index[:n] = kmers[grp]
    value_index = v_off[grp].astype(np.uint64)
    sb = buckets[grp]
    exist = np.full(size, n, np.uint64)
    first = np.ones(n, bool)
    first[1:] = sb[1:] != sb[:-1]
    exist[sb[first]] = np.flatnonzero(first)
    # the terminating key: the first from the top whose bucket is not
    # the last record's (compress.c:549-585)
    last = int(key_index[n - 1]) & (size - 1)
    i = 0
    while last == (int(key_index[i]) & (size - 1)):
        i += 1
    key_index[n] = key_index[i]
    return size, exist, values, key_index, value_index


def write_index(names: Sequence[bytes], codes: np.ndarray,
                offsets: np.ndarray, prefix: str) -> None:
    """Write ``prefix``.comp.b/.length.b/.name/.seq.b of the templates."""
    lens = np.diff(offsets)
    if (lens < K + 1).any():
        raise ValueError("a template of %d bp or less" % K)
    db_size = len(names) + 1
    kmers, offs, flat = _kmer_lists(codes, offsets)
    n = len(kmers)
    size, exist, values, key_index, value_index = _freeze(kmers, offs, flat)
    with open(prefix + ".comp.b", "wb") as f:
        f.write(struct.pack("<III", db_size, K, 0))
        f.write(struct.pack("<QQQQQ", 0, size, n, len(values), n))
        exist.astype("<u4" if n <= U32MAX else "<u8").tofile(f)
        values.astype("<u2" if db_size < U16MAX else "<u4").tofile(f)
        key_index.astype("<u4").tofile(f)
        value_index.astype("<u4" if len(values) < U32MAX
                           else "<u8").tofile(f)
        f.write(struct.pack("<II", K, 0))
    with open(prefix + ".length.b", "wb") as f:
        f.write(struct.pack("<i", db_size))
        np.concatenate([[K], lens]).astype("<u4").tofile(f)
    with open(prefix + ".name", "wb") as f:
        f.write(b"\n".join(names) + b"\n")
    _write_seq(prefix + ".seq.b", codes, offsets)
