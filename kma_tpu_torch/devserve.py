"""devserve daemon on PyTorch/CUDA: the ``kma devserve`` analog of the port.

``TorchDevServer`` holds the DB's index image on the card and answers
the devserve wire protocol, so the native CLI (native/kma_devclient.cpp)
and the Python pipeline's ``DevClient`` attach to it unchanged: the
socket path, the frames, the deadlines, the writer thread and the
pipelined ``dense`` op are the port's own copy of the protocol of
kma_tpu/devserve.py, byte for byte on the wire.  Its ops: ``hello``,
``dense`` (the ``-1t1`` scan), ``chain`` (window probes of the default
chain mode, PE and ``-hmm``), ``nw``, ``nw_codes`` and ``nw_qext`` (the
port's banded-NW kernels), ``pileup`` (the assembly count scatter),
``flush`` and ``stop``.

Protocol: one request/response frame per call,
``u64 header_len | header JSON | concat(raw array bytes)``;
header = {"meta": {...}, "arrays": [[name, dtype, shape], ...]}.
Arrays are C-contiguous little-endian numpy buffers.

The dense image goes on one device when its footprint (the bit table,
the hash tables, two batches' workspace and the other ops' headroom,
``scan_dense.dense_footprint``) fits that device's free memory, or an
explicit budget (``KMA_TPU_DENSE_BUDGET_MB``).  A DB past one
device's budget keeps the dense scanner with the table's template
columns sharded over two or more devices (``devices``; every CUDA card
by default), the hash tables, the ``hello`` list map and the ``chain``
op on the primary device, as the JAX package's mesh keeps them
replicated.  A DB the dense index refuses even so is served by the
pair-stream scanner (``mapping/scan_fast.py``).  Its ``dense`` op runs
on the device; its ``chain`` op is refused, so chain clients take the
host.

On CUDA cards the ``dense`` op of the dense image (a sharded one as its
segments, one graph a segment on the segment's card) and of the
pair-stream image replays one captured CUDA graph of the scan step a
static shape (``scan_dense.StepGraphs``, the counterpart of the JAX jit
cache), at tier 0 and at the wide tier, and the ``chain`` op one graph
of the lookup a rows class and pad (``chain_graphs``); ``warm()``
captures the hot shapes, and ``graphs`` and ``chain_graphs`` count
captures and replays by key.  The NW and pileup ops run eager, in
pieces: each piece's device bytes stay within ``ops_bytes``, the ops
headroom the dense footprint reserves (``scan_dense.OPS_BYTES``), and
the pieces' answers are joined into the one reply the request gets.

An op that raises answers ``{ok: 0, err}`` and the daemon lives on, as
the JAX daemon does; the client's host takes the work over.  A
``Refusal`` (``chain`` on a pair-stream image, an NW request past the
rows it shipped, one alignment or row past ``ops_bytes`` on its own) is
an answer by design; anything else is a fault of
the card or a kernel, counted by op in ``faults``, so that the run that
met it can fail (``launch.serve_run``, ``devserve_main``).

Start it with ``python -m kma_tpu_torch devserve -t_db DB``, or let
``python -m kma_tpu_torch <kma args>`` (``cli.py``, ``launch.py``) start
one for a run that ``-device`` sends to the device.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import os
import queue
import socket
import struct
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import envelope, tracing
from .config import Penalties
from .device import DeviceLike, resolve
from .index.format import load_index
from .mapping.chain_device import CHAIN_ROWS, chain_lookup_dense
from .mapping.device_index import DeviceIndex
from .mapping.scan_dense import (DEFAULT_BATCH, OPS_BYTES, DenseScanner,
                                 dense_image)
from .mapping.scan_fast import FastScanner
from .ops.nw_kernel import (nw_band_score, nw_band_score_codes,
                            nw_band_score_qext)
from .ops.pileup import USHRT_MAX, pileup_counts
from .ops.scan_kernel import run_score_gathered, run_score_rows

KERNELS = (run_score_rows, run_score_gathered, nw_band_score,
           nw_band_score_codes)


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the port's kernel wrappers."""
    return {f.__name__: f.launches for f in KERNELS}


def reset_kernel_launches() -> None:
    for f in KERNELS:
        f.launches = 0


class Refusal(Exception):
    """An ``{ok: 0}`` answer the daemon gives by design, as the JAX
    daemon gives it: not a fault of the card or of a kernel."""


class ChainRefused(Refusal, NotImplementedError):
    """The ``chain`` op on a pair-stream image."""


class RowsRefused(Refusal, ValueError):
    """An NW request whose ``t_len`` passes the rows it shipped."""


class OpsRefused(Refusal, MemoryError):
    """An NW request with one alignment, or a pileup request with one
    row, whose device bytes pass the ops headroom on their own."""


#: device bytes a piece holds beside its per-alignment or per-row bytes:
#: the caching allocator's rounding of each of its tensors (at most 48)
#: up to 512 bytes
PIECE_SLACK = 48 * 512
#: device bytes a byte and a row of a pileup piece hold at the peak of
#: ``pileup._scatter_counts`` (its int64 row, index, prefix and position
#: vectors; 52-61 B a byte measured on the CPU with torch.profiler,
#: tests/test_torch_devserve.py)
PILEUP_BYTES_A_BYTE = 64
PILEUP_BYTES_A_ROW = 64
#: [t_len, 6] int32 matrices a pileup piece holds at once: the running
#: sum, the piece's counts and their clip
PILEUP_MATRICES = 3


def nw_bytes(op: str, arrays) -> int:
    """Device bytes one alignment of an ``nw``, ``nw_codes`` or
    ``nw_qext`` request holds on the card: its t_len, q_len, kflag and
    half-band (int32), its staged slab (``msc``, R x L int8) or codes
    (``qc0`` L, ``tcol`` and ``inj`` R; ``qext`` R + L, ``tcol`` R, uint8)
    and its int32 score."""
    if op == "nw":
        R, _, L = arrays["msc"].shape
        return 20 + R * L
    R = arrays["tcol"].shape[0]
    if op == "nw_codes":
        return 20 + arrays["qc0"].shape[1] + 2 * R
    return 20 + arrays["qext"].shape[1] + R


def fault_line(faults, first: Optional[str]) -> str:
    """``faults 0``, or ``faults dense 2 (RuntimeError('...'))``: a
    daemon's faults by op and its first fault's error."""
    if not faults:
        return "faults 0"
    return "faults %s (%s)" % (", ".join(
        "%s %d" % kv for kv in sorted(faults.items())), first)


# -- wire protocol ------------------------------------------------------------

_HDR = struct.Struct("<Q")

# Deadlines (seconds): once the first byte of a frame arrives the rest
# must follow within FRAME, or the connection is dropped; a connected but
# silent client (the native CLI between batches) is kept for IDLE.
_FRAME_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_FRAME_TIMEOUT", 60))
_IDLE_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_IDLE_TIMEOUT", 3600))


def _fnv1a64(s: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in s:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _sock_dir() -> str:
    return os.environ.get("KMA_DEVSERVE_DIR") or os.path.join(
        tempfile.gettempdir(), "kma_devserve_%d" % os.getuid())


def socket_path(db_prefix: str) -> str:
    """Per-DB socket path, keyed by FNV-1a of the resolved prefix (the
    hash the native CLI computes, kma_devclient.cpp:317-333)."""
    real = os.path.realpath(db_prefix)
    return os.path.join(_sock_dir(), "%016x.sock" % _fnv1a64(real.encode()))


def probe_live(db_prefix: str, timeout: float = 3.0) -> bool:
    """True when a daemon is accepting connections for this DB's socket
    (no handshake), so a duplicate daemon is refused before its build."""
    path = os.environ.get("KMA_DEVSERVE_SOCKET") or socket_path(db_prefix)
    if not os.path.exists(path):
        return False
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(timeout)
    try:
        s.connect(path)
        return True
    except OSError:
        return False
    finally:
        s.close()


def reap_stale_sockets() -> None:
    """Unlink sockets in the devserve dir whose daemon is gone."""
    d = _sock_dir()
    try:
        names = os.listdir(d)
    except OSError:
        return
    for n in names:
        if not n.endswith(".sock"):
            continue
        p = os.path.join(d, n)
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(1.0)
        try:
            s.connect(p)
        except (ConnectionRefusedError, FileNotFoundError):
            try:
                os.unlink(p)
            except OSError:
                pass
        except OSError:
            pass
        finally:
            s.close()


def db_signature(db_prefix: str) -> List:
    """Cheap DB identity: size+mtime of the frozen hashmap file."""
    for ext in (".comp.b", ".b"):
        p = db_prefix + ext
        if os.path.exists(p):
            st = os.stat(p)
            return [ext, st.st_size, int(st.st_mtime)]
    return ["?", 0, 0]


def _send(sock: socket.socket, meta: dict,
          arrays: Optional[List[Tuple[str, np.ndarray]]] = None) -> None:
    arrays = arrays or []
    desc = []
    bufs = []
    for name, a in arrays:
        a = np.ascontiguousarray(a)
        desc.append([name, a.dtype.str, list(a.shape)])
        bufs.append(a)
    hdr = json.dumps({"meta": meta, "arrays": desc}).encode()
    sock.sendall(_HDR.pack(len(hdr)))
    sock.sendall(hdr)
    for a in bufs:
        sock.sendall(memoryview(a).cast("B"))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise EOFError("peer closed")
        got += r
    return buf


def _recv(sock: socket.socket, idle_timeout: Optional[float] = None,
          frame_timeout: Optional[float] = None
          ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Receive one frame.  With timeouts set: wait up to idle_timeout
    for the frame to start, then up to frame_timeout for the rest;
    socket.timeout propagates to the caller, who drops the peer."""
    head = _recv_head(sock, idle_timeout)
    return _recv_rest(sock, head, frame_timeout)


def _recv_head(sock: socket.socket, idle_timeout: Optional[float]
               ) -> bytearray:
    """A frame's length word, once the frame starts."""
    if idle_timeout is not None:
        sock.settimeout(idle_timeout)
    return _recv_exact(sock, _HDR.size)


def _recv_rest(sock: socket.socket, head: bytearray,
               frame_timeout: Optional[float]
               ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """The rest of the frame ``head`` starts: (meta, arrays)."""
    if frame_timeout is not None:
        sock.settimeout(frame_timeout)
    (hlen,) = _HDR.unpack(bytes(head))
    if hlen > (64 << 20):
        raise EOFError("oversized frame header")
    hdr = json.loads(bytes(_recv_exact(sock, hlen)))
    arrays = {}
    for name, dt, shape in hdr["arrays"]:
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        raw = _recv_exact(sock, n)
        arrays[name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    return hdr["meta"], arrays


def _pack_tid_lists(tid_lists) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged list-of-arrays -> (has u8, counts i32, flat i32)."""
    has = np.fromiter((t is not None for t in tid_lists), np.uint8,
                      len(tid_lists))
    counts = np.fromiter((0 if t is None else len(t) for t in tid_lists),
                         np.int32, len(tid_lists))
    flat = np.empty(int(counts.sum()), np.int32)
    off = 0
    for t in tid_lists:
        if t is not None and len(t):
            flat[off: off + len(t)] = t
            off += len(t)
    return has, counts, flat


def _unpack_tid_lists(has, counts, flat) -> list:
    offs = np.cumsum(counts) - counts
    out: list = [None] * len(has)
    for i in range(len(has)):
        if has[i]:
            out[i] = flat[offs[i]: offs[i] + counts[i]]
    return out


class TorchDevServer:
    """Holds the device-resident index image and the port's scanners."""

    def __init__(self, db_prefix: str, batch: int = DEFAULT_BATCH,
                 device: DeviceLike = None,
                 devices: Optional[List[DeviceLike]] = None,
                 ops_bytes: int = OPS_BYTES):
        """The image goes on ``device``, else (its dense footprint over
        that device's budget: ``KMA_TPU_DENSE_BUDGET_MB``, else its free
        memory) sharded over
        ``devices`` when they are two or more (None: every CUDA card when
        ``device`` is None too), else the pair-stream image goes on
        ``device``.  ``device`` None with ``devices`` given means
        ``devices[0]``.  ``ops_bytes`` bounds the device bytes of each
        piece of an NW or pileup request (default: the dense footprint's
        ops headroom)."""
        self.ops_bytes = int(ops_bytes)
        self.device = resolve(device if device is not None or not devices
                              else devices[0])
        self.db = os.path.realpath(db_prefix)
        self.sig = db_signature(db_prefix)
        self.idx = load_index(db_prefix)
        self.batch = batch
        #: "dense" or "pair_stream": the scanner that serves the DB
        self.scanner_kind = "dense"
        t0 = time.perf_counter()
        try:
            self.didx = dense_image(self.idx, device, devices=devices,
                                    batch=batch)
        except NotImplementedError:
            # the pair-stream image scales with the DB's k-mers, not
            # with lists x templates (kmers.c:84-125 scale story)
            print("# device scanner: dense membership over budget; "
                  "using the pair-stream scanner", file=sys.stderr)
            self.didx = DeviceIndex.from_host(self.idx, self.device)
            self.scanner_kind = "pair_stream"
            self._scanner_cls = functools.partial(FastScanner,
                                                  device=self.device)
            # no list ids go out: the chain op is refused
            self.voff_map = np.zeros(0, np.int64)
        else:
            self.device = self.didx.device
            self._scanner_cls = DenseScanner
            self.voff_map = np.asarray(self.didx.list_voff, np.int64)
        #: seconds the device image took to build
        self.build_s = time.perf_counter() - t0
        if self.scanner_kind == "dense":
            d = self.didx
            print("# device scanner: dense image, %d lists x t_pad %d on "
                  "%s; footprint %s MB of budget %s MB a device; built in "
                  "%.1f s" % (d.n_lists, d.t_pad,
                              ", ".join(map(str, d.devices)),
                              ", ".join("%.1f" % (f.total / 2 ** 20)
                                        for f in d.footprint),
                              ", ".join("%.1f" % (b / 2 ** 20)
                                        for b in d.budget), self.build_s),
                  file=sys.stderr)
        self._default_pen = Penalties()
        self.scanners: Dict[tuple, object] = {}
        self._stats_lock = threading.Lock()
        #: serialises the ops' device work over the connections
        self.op_lock = threading.Lock()
        #: requests served per op ("dense" counts pipelined ones too)
        self.requests: collections.Counter = collections.Counter()
        #: the span record of the requests served (``tracing``)
        self.spans = tracing.Recorder(self.device, self._stats_lock)
        #: wall ms of each dense request the record holds, dispatch plus
        #: resolve, in resolve order (a view of ``spans``)
        self.dense_ms = tracing.DenseMs(self.spans)
        #: reads answered by the dense op, and those flagged overflow
        #: (the client's host scanner rescans them)
        self.reads_scanned = 0
        self.reads_overflow = 0
        #: faults by op: an op, the dense dispatch or its resolve raised
        #: something other than a Refusal (a CUDA error, a kernel's
        #: RuntimeError, out of memory); the client's host takes over
        self.faults: collections.Counter = collections.Counter()
        #: repr of the first fault's error
        self.first_fault: Optional[str] = None
        #: pieces the NW and pileup ops ran, by op
        self.op_pieces: collections.Counter = collections.Counter()

    def _count(self, op: str) -> None:
        with self._stats_lock:
            self.requests[op] += 1

    def _error(self, op: str, e: Exception) -> dict:
        """The ``{ok: 0}`` reply to an op that raised ``e``, counting a
        fault unless ``e`` is a refusal."""
        if not isinstance(e, Refusal):
            with self._stats_lock:
                self.faults[op] += 1
                if self.first_fault is None:
                    self.first_fault = repr(e)
        return {"ok": 0, "err": repr(e)}

    def fault_line(self) -> str:
        return fault_line(self.faults, self.first_fault)

    @property
    def graphs(self):
        """The scan step's graphs (``scan_dense.StepGraphs``): captures
        and replays by key, on a dense image (sharded or not) or the
        pair-stream image on CUDA cards; None where the dense op runs
        eager (the CPU)."""
        return self.didx.graphs

    @property
    def chain_graphs(self):
        """The chain op's graphs (a dense image's ``chain_graphs`` on a
        card); None where it runs eager (the CPU) or is refused (the
        pair-stream image)."""
        return getattr(self.didx, "chain_graphs", None)

    # -- ops ---------------------------------------------------------------

    def _scanner(self, meta: dict):
        """The scanner of one penalty set (built once, sharing the
        image)."""
        key = (int(meta["M"]), int(meta["MM"]), int(meta["U"]),
               int(meta["W1"]), bool(meta.get("exhaustive")),
               meta.get("proxi_frac"))
        sc = self.scanners.get(key)
        if sc is None:
            pen = dataclasses.replace(self._default_pen, M=key[0],
                                      MM=key[1], U=key[2], W1=key[3])
            sc = self._scanner_cls(self.idx, pen, exhaustive=key[4],
                                   proxi_frac=key[5], batch=self.batch,
                                   didx=self.didx)
            self.scanners[key] = sc
        return sc

    def _dense_dispatch(self, meta, arrays):
        """Dispatch half of the dense op: (scanner, (handle, request))
        for _dense_pack; the request is the serve loop's, else a new
        one of ``spans``."""
        self._count("dense")
        if meta.get("pipeline"):
            self._count("dense_pipelined")
        req = tracing.current() or self.spans.request()
        try:
            with req.span(tracing.DISPATCH) as sp:
                sc = self._scanner(meta)
                h = sc.scan_dispatch(np.asarray(arrays["codes"]),
                                     np.asarray(arrays["lengths"]))
        except BaseException:
            req.settle()
            raise
        req.dispatch_ns = round(1e9 * (sp.t1 - sp.t0))
        return sc, (h, req)

    def _dense_pack(self, sc, h_req):
        h, req = h_req
        synced = False
        try:
            with req.span(tracing.RESOLVE, b=req.dispatch_ns):
                scores, modes, tid_lists, over = sc.scan_resolve(h)
            synced = True
        finally:
            req.settle(synced)
        with self._stats_lock:
            self.reads_scanned += len(over)
            self.reads_overflow += int(over.sum())
        with req.span(tracing.PACK):
            has, counts, flat = _pack_tid_lists(tid_lists)
            return {"ok": 1}, [("scores", scores.astype(np.int32)),
                               ("modes", modes.astype(np.uint8)),
                               ("over", over.astype(np.uint8)),
                               ("has", has), ("counts", counts),
                               ("flat", flat)]

    def _op_dense(self, meta, arrays):
        return self._dense_pack(*self._dense_dispatch(meta, arrays))

    def _op_hello(self, meta, arrays):
        self._count("hello")
        if meta.get("db") != self.db or meta.get("sig") != self.sig:
            return {"ok": 0, "err": "db mismatch: serving %s" % self.db}, []
        return {"ok": 1, "k": int(self.idx.kmersize),
                "db_size": int(self.idx.db_size)}, \
            [("voff_map", self.voff_map)]

    def _up(self, a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(self.device)

    @staticmethod
    def _check_rows(arrays, R: int):
        """Refuse an alignment with more rows than were shipped, on the
        host copy of t_len before any upload (the kernel would score it
        REFUSED, a number the clients do not know)."""
        t_len = arrays["t_len"]
        if len(t_len) and int(np.max(t_len)) > R:
            raise RowsRefused("t_len %d exceeds the %d rows shipped"
                              % (int(np.max(t_len)), R))

    def _pieces(self, op: str, cost: np.ndarray, fixed: int) -> List[slice]:
        """Consecutive slices of the items whose device bytes are
        ``cost`` (one an item), each holding at most ``ops_bytes`` with
        ``fixed`` bytes beside them; counted in ``op_pieces``.
        OpsRefused when one item does not fit alone."""
        room = self.ops_bytes - fixed
        if len(cost) and int(cost.max()) > room:
            raise OpsRefused("%s: one item holds %d device bytes, past the "
                             "ops headroom of %d" % (
                                 op, int(cost.max()) + fixed,
                                 self.ops_bytes))
        cum = np.concatenate([[0], np.cumsum(cost, dtype=np.int64)])
        cuts, a = [], 0
        while True:
            b = int(np.searchsorted(cum, cum[a] + room, side="right")) - 1
            cuts.append(slice(a, b))
            if b >= len(cost):
                break
            a = b
        with self._stats_lock:
            self.op_pieces[op] += len(cuts)
        return cuts

    def _nw_pieces(self, op: str, arrays) -> List[slice]:
        B = len(arrays["t_len"])
        return self._pieces(op, np.full(B, nw_bytes(op, arrays), np.int64),
                            PIECE_SLACK)

    def _op_chain(self, meta, arrays):
        self._count("chain")
        if self.scanner_kind != "dense":
            # as the JAX package keeps chain probes of such DBs on the
            # host (chain_device.py:288-289); the reply is {"ok": 0}
            raise ChainRefused("device chain lookup needs the dense index")
        rows_f, rows_rc = chain_lookup_dense(self.didx, self.idx,
                                             arrays["codes"],
                                             arrays["lengths"])
        tracing.annotate(rows_f.shape[0], rows_f.shape[1])
        return {"ok": 1}, [("rows_f", rows_f), ("rows_rc", rows_rc)]

    def _op_nw(self, meta, arrays):
        self._count("nw")
        msc = arrays["msc"]
        self._check_rows(arrays, msc.shape[0])
        kw = dict(W1=int(meta["W1"]), U=int(meta["U"]), MM=int(meta["MM"]))
        out = []
        for s in self._nw_pieces("nw", arrays):
            hb = self._up(arrays["hband"][s], np.int32) \
                if "hband" in arrays else int(meta["half_band"])
            out.append(nw_band_score(
                *(self._up(arrays[n][s], np.int32)
                  for n in ("t_len", "q_len", "kflag")),
                self._up(msc[:, s], np.int8), hb, **kw).cpu().numpy())
        return {"ok": 1}, [("scores", np.concatenate(out).astype(np.int32))]

    def _op_nw_codes(self, meta, arrays):
        self._count("nw_codes")
        self._check_rows(arrays, arrays["tcol"].shape[0])
        kw = dict(dmat=np.asarray(meta["dmat"], np.int64),
                  W1=int(meta["W1"]), U=int(meta["U"]), MM=int(meta["MM"]))
        out = []
        for s in self._nw_pieces("nw_codes", arrays):
            out.append(nw_band_score_codes(
                *(self._up(arrays[n][s], np.int32)
                  for n in ("t_len", "q_len", "kflag", "hband")),
                self._up(arrays["qc0"][s], np.uint8),
                *(self._up(arrays[n][:, s], np.uint8)
                  for n in ("tcol", "inj")), **kw).cpu().numpy())
        return {"ok": 1}, [("scores", np.concatenate(out).astype(np.int32))]

    def _op_nw_qext(self, meta, arrays):
        self._count("nw_qext")
        self._check_rows(arrays, arrays["tcol"].shape[0])
        kw = dict(dmat=np.asarray(meta["dmat"], np.int64),
                  W1=int(meta["W1"]), U=int(meta["U"]), MM=int(meta["MM"]))
        out = []
        for s in self._nw_pieces("nw_qext", arrays):
            out.append(nw_band_score_qext(
                *(self._up(arrays[n][s], np.int32)
                  for n in ("t_len", "q_len", "kflag", "hband")),
                self._up(arrays["qext"][s], np.uint8),
                self._up(arrays["tcol"][:, s], np.uint8),
                **kw).cpu().numpy())
        return {"ok": 1}, [("scores", np.concatenate(out).astype(np.int32))]

    def _op_pileup(self, meta, arrays):
        """The delta matrix of the request's rows: the saturated sum of
        its pieces' (cut at row boundaries), which equals one call's, as
        u16 saturation of +1 updates is sum-then-clip."""
        self._count("pileup")
        offs = np.asarray(arrays["offs"], np.int64)
        t_len = int(meta["t_len"])
        cost = PILEUP_BYTES_A_BYTE * np.diff(offs) + PILEUP_BYTES_A_ROW
        total = None
        for s in self._pieces("pileup", cost, PIECE_SLACK
                              + PILEUP_MATRICES * 4 * (6 * t_len + 1)):
            d = pileup_counts(arrays["t_flat"], arrays["q_flat"],
                              offs[s.start: s.stop + 1],
                              arrays["starts"][s], t_len, self.device)
            total = d if total is None \
                else total.add_(d).clamp_(max=USHRT_MAX)
            del d
        return {"ok": 1}, [("delta", total.cpu().numpy().astype(np.int64))]

    # -- warm-up -----------------------------------------------------------

    def warm(self, lengths=(128,), verbose=True):
        """Build the kernels and run the hot shapes once, tier 0 and tier
        1 at each of ``lengths`` (the JAX daemon compiles them), so the
        first client batch pays no build or allocator warm-up: on a CUDA
        card that captures the scan step's graphs of those shapes, tier
        0 and the wide tier of either scanner (``graphs``), as the JAX
        ``warm()`` compiles its jits."""
        rng = np.random.default_rng(0)
        sc = self._scanner({"M": self._default_pen.M,
                            "MM": self._default_pen.MM,
                            "U": self._default_pen.U,
                            "W1": self._default_pen.W1,
                            "exhaustive": False, "proxi_frac": None})
        for L in lengths:
            t0 = time.time()
            codes = rng.integers(0, 4, (self.batch, L), dtype=np.uint8)
            lens = np.full(self.batch, min(100, L), np.int32)
            sc.scan_reads(codes, lens)
            # tier-1 rescan shape (fires on overflow ties)
            for _ in sc._wide(codes, lens,
                              np.arange(min(8, self.batch))):
                pass
            # every shard ran, so each card has loaded the kernels
            for dev in set(getattr(self.didx, "devices", [self.device])):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            if verbose:
                print("# devserve: warmed dense L=%d in %.1fs%s"
                      % (L, time.time() - t0, "" if self.graphs is None
                         else " (graphs captured: %d)"
                         % sum(self.graphs.captures.values())),
                      file=sys.stderr)
        # chain lookup shapes (default mode, PE and -hmm): on a card the
        # graphs of the clients' request rows (CHAIN_ROWS)
        cg = self.chain_graphs
        if self.scanner_kind == "dense" and self.didx.kmersize <= 16:
            for L in lengths:
                t0 = time.time()
                for rows in (CHAIN_ROWS if cg is not None
                             else (self.batch,)):
                    chain_lookup_dense(
                        self.didx, self.idx,
                        rng.integers(0, 4, (rows, L), dtype=np.uint8),
                        np.full(rows, min(100, L), np.int32))
                if verbose:
                    print("# devserve: warmed chain L=%d in %.1fs%s"
                          % (L, time.time() - t0, "" if cg is None
                             else " (chain graphs captured: %d)"
                             % sum(cg.captures.values())), file=sys.stderr)


    # -- serve loop ----------------------------------------------------------

    def serve(self, sock_path: Optional[str] = None,
              ready_cb=None) -> None:
        """Accept clients on the DB's socket until a ``stop`` request.

        Each connection gets its own thread with per-frame deadlines, so
        a peer that dies mid-frame stalls only its own thread; device
        work is serialised under one lock.  A connection's reads and
        writes are decoupled (a writer thread drains its replies in
        order), since clients pipeline requests and a handler blocked
        sending reply k while the client sends request k+2 would
        deadlock both once the socket buffers fill.  A ``dense`` request
        with the "pipeline" flag is dispatched at once and answered when
        the next request arrives, so one request's upload and dispatch
        overlap the previous one's device work; ``flush`` ends the
        stream.  Every frame is a request of ``spans``: the connection's
        number and the frame's on it."""
        sock_path = sock_path or socket_path(self.db)
        d = os.path.dirname(sock_path)
        os.makedirs(d, exist_ok=True)
        try:
            os.chmod(d, 0o700)
        except OSError:
            pass
        if os.path.exists(sock_path):
            # stale socket from a dead daemon: connectable means live
            probe = socket.socket(socket.AF_UNIX)
            try:
                probe.connect(sock_path)
                raise RuntimeError("devserve already running at %s"
                                   % sock_path)
            except (ConnectionRefusedError, FileNotFoundError):
                os.unlink(sock_path)
            finally:
                probe.close()
        srv = socket.socket(socket.AF_UNIX)
        srv.bind(sock_path)
        srv.listen(8)
        print("# devserve: serving %s at %s" % (self.db, sock_path),
              file=sys.stderr, flush=True)
        self.spans.anchor()
        if ready_cb is not None:
            ready_cb()
        ops = {"dense": self._op_dense, "chain": self._op_chain,
               "nw": self._op_nw, "nw_codes": self._op_nw_codes,
               "nw_qext": self._op_nw_qext,
               "pileup": self._op_pileup, "hello": self._op_hello}
        stop_ev = threading.Event()
        op_lock = self.op_lock

        def handle(conn: socket.socket, cid: int) -> None:
            sendq: queue.Queue = queue.Queue()

            def writer():
                while True:
                    item = sendq.get()
                    if item is None:
                        return
                    try:
                        _send(conn, item[0], item[1])
                    except (OSError, ValueError):
                        # client gone or not reading: drop the
                        # connection; the reader's recv fails
                        try:
                            conn.close()
                        except OSError:
                            pass
                        return

            wt = threading.Thread(target=writer, daemon=True)
            wt.start()
            # (scanner, (handle, request)) of pipelined dense requests
            pending = []

            def resolve_pending():
                while pending:
                    sc, h = pending.pop(0)
                    with h[1].under(op_lock):
                        try:
                            rm, ra = self._dense_pack(sc, h)
                        except Exception as e:
                            rm, ra = self._error("dense", e), []
                    sendq.put((rm, ra))

            try:
                for seq in itertools.count():
                    if stop_ev.is_set():
                        break
                    try:
                        head = _recv_head(conn, _IDLE_TIMEOUT)
                        t0 = time.perf_counter()
                        meta, arrays = _recv_rest(conn, head,
                                                  _FRAME_TIMEOUT)
                    except socket.timeout:
                        print("# devserve: dropping stalled client",
                              file=sys.stderr, flush=True)
                        return
                    req = self.spans.request(cid, seq)
                    req.add(tracing.RECV, t0, time.perf_counter())
                    op = meta.get("op")
                    if op == "dense" and meta.get("pipeline"):
                        try:
                            with req.under(op_lock):
                                sc_h = self._dense_dispatch(meta, arrays)
                        except Exception as e:
                            resolve_pending()
                            sendq.put((self._error("dense", e), []))
                            continue
                        resolve_pending()
                        pending.append(sc_h)
                        continue
                    resolve_pending()
                    if op == "flush":
                        sendq.put(({"ok": 1}, []))
                        continue
                    if op == "stop":
                        sendq.put(({"ok": 1}, []))
                        stop_ev.set()
                        # unblock accept()
                        try:
                            poke = socket.socket(socket.AF_UNIX)
                            poke.settimeout(1.0)
                            poke.connect(sock_path)
                            poke.close()
                        except OSError:
                            pass
                        return
                    fn = ops.get(op)
                    if fn is None:
                        sendq.put(({"ok": 0, "err": "bad op %r" % op},
                                   []))
                        continue
                    try:
                        with req.under(op_lock):
                            if op == "dense":
                                rmeta, rarrays = fn(meta, arrays)
                            else:
                                with req.span(tracing.OPS[op]):
                                    rmeta, rarrays = fn(meta, arrays)
                    except Exception as e:  # keep the daemon alive
                        sendq.put((self._error(op, e), []))
                        continue
                    sendq.put((rmeta, rarrays))
            except (EOFError, ConnectionResetError, BrokenPipeError,
                    OSError):
                pass
            finally:
                if pending:                 # a client that left
                    with op_lock:
                        for _, h in pending:
                            h[1].settle()
                sendq.put(None)
                wt.join(timeout=_FRAME_TIMEOUT + 5)
                try:
                    conn.close()
                except OSError:
                    pass

        threads: List[threading.Thread] = []
        for cid in itertools.count():
            if stop_ev.is_set():
                break
            try:
                conn, _ = srv.accept()
            except OSError:
                break
            if stop_ev.is_set():
                conn.close()
                break
            t = threading.Thread(target=handle, args=(conn, cid),
                                 daemon=True)
            t.start()
            threads.append(t)
            threads = [t for t in threads if t.is_alive()]
        srv.close()
        for t in threads:
            t.join(timeout=5.0)
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        print("# devserve: stopped", file=sys.stderr)


# -- client -------------------------------------------------------------------


class DevClient:
    """Socket client of a running daemon: the handshake and every op
    call of kma_tpu's ``DevClient``, frame for frame (numpy and a unix
    socket only).  The ``GT`` and ``interpret`` fields of the NW
    requests are the JAX client's, sent as it sends them; the torch
    daemon ignores them."""

    #: per-request deadline; a wedged daemon costs at most this much
    CALL_TIMEOUT = float(os.environ.get("KMA_DEVSERVE_CALL_TIMEOUT", 300))

    def __init__(self, sock: socket.socket, k: int, db_size: int,
                 voff_map: np.ndarray):
        self._sock = sock
        self.k = k
        self.db_size = db_size
        self.voff_map = voff_map

    @classmethod
    def connect(cls, db_prefix: str, timeout: Optional[float] = None,
                sock_path: Optional[str] = None) -> Optional["DevClient"]:
        """Connect and check the DB's identity; None when no live daemon
        serves it.  The socket is ``sock_path``, else
        ``KMA_DEVSERVE_SOCKET``, else the DB's.  The handshake deadline
        is short: a healthy daemon answers hello in milliseconds."""
        if timeout is None:
            timeout = float(os.environ.get("KMA_DEVSERVE_HELLO_TIMEOUT",
                                           15))
        path = sock_path or os.environ.get("KMA_DEVSERVE_SOCKET") \
            or socket_path(db_prefix)
        if not os.path.exists(path):
            return None
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(timeout)
        try:
            s.connect(path)
            _send(s, {"op": "hello", "db": os.path.realpath(db_prefix),
                      "sig": db_signature(db_prefix)})
            meta, arrays = _recv(s)
        except (OSError, EOFError):
            s.close()
            return None
        if not meta.get("ok"):
            print("# devserve: %s" % meta.get("err", "handshake failed"),
                  file=sys.stderr)
            s.close()
            return None
        return cls(s, int(meta["k"]), int(meta["db_size"]),
                   np.asarray(arrays["voff_map"], np.int64))

    def _reply(self) -> Dict[str, np.ndarray]:
        rmeta, r = _recv(self._sock)
        if not rmeta.get("ok"):
            raise RuntimeError("devserve error: %s" % rmeta.get("err", "?"))
        return r

    def _post(self, meta: dict, arrays) -> None:
        self._sock.settimeout(self.CALL_TIMEOUT)
        _send(self._sock, meta, arrays)

    def _call(self, meta: dict, arrays) -> Dict[str, np.ndarray]:
        self._post(meta, arrays)
        return self._reply()

    def dense_scan(self, codes: np.ndarray, lengths: np.ndarray, pen,
                   exhaustive: bool, proxi_frac):
        """One ``-1t1`` scan request: (scores, modes, tie lists,
        overflow flags) per read."""
        meta = {"op": "dense", "M": int(pen.M), "MM": int(pen.MM),
                "U": int(pen.U), "W1": int(pen.W1),
                "exhaustive": bool(exhaustive), "proxi_frac": proxi_frac}
        r = self._call(meta, [("codes", codes.astype(np.uint8)),
                              ("lengths", lengths.astype(np.int32))])
        tid_lists = _unpack_tid_lists(r["has"], r["counts"],
                                      np.asarray(r["flat"], np.int32))
        return (np.asarray(r["scores"]), np.asarray(r["modes"]),
                tid_lists, np.asarray(r["over"]).astype(bool))

    def chain_lookup(self, codes: np.ndarray, lengths: np.ndarray):
        """Per-window list ids of both strands (``chain``): (rows_f,
        rows_rc) [B, W] int32."""
        r = self._call({"op": "chain"},
                       [("codes", codes.astype(np.uint8)),
                        ("lengths", lengths.astype(np.int32))])
        return np.asarray(r["rows_f"]), np.asarray(r["rows_rc"])

    def nw_scores(self, t_len, q_len, kflag, msc, *, half_band, W1, U,
                  MM):
        """Banded-NW scores of a shipped match-score slab (``nw``)."""
        meta = {"op": "nw", "W1": int(W1), "U": int(U), "MM": int(MM),
                "GT": 8, "interpret": False}
        arrays = [("t_len", np.asarray(t_len, np.int32)),
                  ("q_len", np.asarray(q_len, np.int32)),
                  ("kflag", np.asarray(kflag, np.int32)),
                  ("msc", np.asarray(msc, np.int8))]
        if np.ndim(half_band):
            arrays.append(("hband", np.asarray(half_band, np.int32)))
        else:
            meta["half_band"] = int(half_band)
        return np.asarray(self._call(meta, arrays)["scores"])

    @staticmethod
    def _nw_meta(op, dmat, W1, U, MM, GT):
        return {"op": op, "W1": int(W1), "U": int(U), "MM": int(MM),
                "GT": GT, "interpret": False,
                "dmat": [[int(x) for x in row] for row in dmat]}

    def nw_scores_codes(self, t_len, q_len, kflag, hband, qc0, tcol, inj,
                        *, dmat, W1, U, MM):
        """Codes-fed banded-NW scores (``nw_codes``), one round trip."""
        self.nw_scores_codes_send(t_len, q_len, kflag, hband, qc0, tcol,
                                  inj, dmat=dmat, W1=W1, U=U, MM=MM)
        return self.nw_scores_codes_recv()

    def nw_scores_codes_send(self, t_len, q_len, kflag, hband, qc0, tcol,
                             inj, *, dmat, W1, U, MM):
        """Send one ``nw_codes`` request without waiting: replies come in
        request order, so several may be in flight."""
        self._post(self._nw_meta("nw_codes", dmat, W1, U, MM, 8),
                   [("t_len", np.asarray(t_len, np.int32)),
                    ("q_len", np.asarray(q_len, np.int32)),
                    ("kflag", np.asarray(kflag, np.int32)),
                    ("hband", np.asarray(hband, np.int32)),
                    ("qc0", np.asarray(qc0, np.uint8)),
                    ("tcol", np.asarray(tcol, np.uint8)),
                    ("inj", np.asarray(inj, np.uint8))])

    def nw_scores_codes_recv(self):
        return np.asarray(self._reply()["scores"])

    def nw_scores_qext(self, t_len, q_len, kflag, hband, qext, tcol, *,
                       dmat, W1, U, MM):
        """Banded-NW scores from extended query codes (``nw_qext``, the
        step-3 pre-pass's op), one round trip."""
        self.nw_scores_qext_send(t_len, q_len, kflag, hband, qext, tcol,
                                 dmat=dmat, W1=W1, U=U, MM=MM)
        return self.nw_scores_qext_recv()

    def nw_scores_qext_send(self, t_len, q_len, kflag, hband, qext, tcol,
                            *, dmat, W1, U, MM):
        """Send one ``nw_qext`` request without waiting (replies come in
        request order)."""
        self._post(self._nw_meta("nw_qext", dmat, W1, U, MM, 64),
                   [("t_len", np.asarray(t_len, np.int32)),
                    ("q_len", np.asarray(q_len, np.int32)),
                    ("kflag", np.asarray(kflag, np.int32)),
                    ("hband", np.asarray(hband, np.int32)),
                    ("qext", np.asarray(qext, np.uint8)),
                    ("tcol", np.asarray(tcol, np.uint8))])

    def nw_scores_qext_recv(self):
        return np.asarray(self._reply()["scores"])

    def pileup(self, t_flat, q_flat, offs, starts, t_len: int):
        """The [t_len, 6] int64 count delta of aligned rows (``pileup``)."""
        r = self._call({"op": "pileup", "t_len": int(t_len)},
                       [("t_flat", np.asarray(t_flat, np.uint8)),
                        ("q_flat", np.asarray(q_flat, np.uint8)),
                        ("offs", np.asarray(offs, np.int64)),
                        ("starts", np.asarray(starts, np.int32))])
        return np.asarray(r["delta"], np.int64)

    def stop(self) -> None:
        """Shut the daemon down, then close."""
        _send(self._sock, {"op": "stop"})
        try:
            _recv(self._sock)
        except EOFError:
            pass
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def devserve_main(argv: List[str]) -> int:
    """``python -m kma_tpu_torch devserve -t_db DB [-b] [-stop]
    [-warm L1,L2,..] [-batch N]`` (the flags of kma_tpu's devserve).

    -b daemonizes (double fork); -stop shuts a running daemon down.
    The daemon runs on the CUDA card and refuses to start without one.
    At stop it prints its faults and exits 1 if there were any.
    """
    db = None
    bg = False
    stop = False
    warm_lens = [128]
    batch = DEFAULT_BATCH
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-t_db":
            i += 1
            db = argv[i]
        elif a == "-b":
            bg = True
        elif a == "-stop":
            stop = True
        elif a == "-warm":
            i += 1
            warm_lens = [int(x) for x in argv[i].split(",") if x]
        elif a == "-batch":
            i += 1
            batch = int(argv[i])
        elif a in ("-h", "--help"):
            print(devserve_main.__doc__)
            return 0
        else:
            print("# Invalid option:\t%s" % a, file=sys.stderr)
            return 1
        i += 1
    if db is None:
        print("devserve needs -t_db", file=sys.stderr)
        return 1
    if stop:
        cli = DevClient.connect(db)
        if cli is None:
            print("# devserve: no daemon for %s" % db, file=sys.stderr)
            return 1
        cli.stop()
        print("# devserve: stopped daemon for %s" % db, file=sys.stderr)
        return 0
    reap_stale_sockets()
    if probe_live(db):
        print("# devserve: already running for %s" % db, file=sys.stderr)
        return 1
    # bin/kma -device on reads these from its own environment
    print("# devserve: %s; export them for bin/kma -device on"
          % envelope.figures_line(os.environ), file=sys.stderr)
    if not bg:
        srv = TorchDevServer(db, batch=batch)
        srv.warm(warm_lens)
        srv.serve()
        return _stopped(srv)
    # double-fork daemonization; the child signals readiness (socket
    # bound, shapes warm) through a pipe
    r, w = os.pipe()
    pid = os.fork()
    if pid:
        os.close(w)
        msg = os.read(r, 64)
        os.close(r)
        if msg.startswith(b"ready"):
            print("# devserve: daemon ready (pid %s)"
                  % msg.split()[1].decode(), file=sys.stderr)
            return 0
        print("# devserve: daemon failed to start", file=sys.stderr)
        return 1
    os.close(r)
    os.setsid()
    if os.fork():
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    os.dup2(devnull, 0)
    log = os.environ.get("KMA_DEVSERVE_LOG")
    out = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600) \
        if log else devnull
    os.dup2(out, 1)
    os.dup2(out, 2)

    def ready():
        os.write(w, b"ready %d" % os.getpid())
        os.close(w)

    try:
        srv = TorchDevServer(db, batch=batch)
        srv.warm(warm_lens)
        srv.serve(ready_cb=ready)
    finally:
        try:
            os.close(w)
        except OSError:
            pass
    return _stopped(srv)


def _stopped(srv: TorchDevServer) -> int:
    """A stopped daemon's exit code: 1 when it faulted, so that a run
    whose clients the host finished does not pass as a card run."""
    print("# devserve: %s" % tracing.span_line(srv.spans), file=sys.stderr)
    print("# devserve: %s" % srv.fault_line(), file=sys.stderr)
    return 1 if srv.faults else 0
