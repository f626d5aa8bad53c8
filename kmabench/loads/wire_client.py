"""The wire load's clients: one process, one thread a client, each
client a connection to the daemon that speaks as the native CLI's client
(``native/kma_devclient.cpp``) does on a ``-1t1`` run: every request a
``dense`` frame with the ``pipeline`` flag, up to ``depth`` requests
ahead of the reply it reads (``KMA_DEVDEPTH``, kma_cli.cpp:1007-1009),
replies read in order, and a ``flush`` at the end of the stream that
releases the last reply.  A request's reads are padded to the native
client's length bucket (``pad_len``, kma_cli.cpp:1031-1036).

``python3 kmabench/loads/wire_client.py PARAMS.json``, started by
``wire.py``; it talks with it by lines:

- it makes the request pool from the seed, writes it to
  ``PARAMS["pool"]`` and prints ``ready``;
- on ``warm``: every client connects and sends one of the pool's
  requests with a read that reaches the wide tier, so the daemon
  captures every step graph the window replays, then it prints
  ``warmed``;
- on ``go T0 T1``: each client sends until ``T1`` (``time.perf_counter``,
  the host's monotonic clock, which both processes share) and then
  flushes; what is in flight then is finished.  A request's time runs
  from the start of its send to the end of its reply; every reply to a
  request the pool sent before must equal the first, and a sample of its
  reads drawn from the seed is kept for the reference; it writes the
  record to ``PARAMS["out"]`` and prints ``done``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import socket
import struct
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HDR = struct.Struct("<Q")


def pad_len(mx: int) -> int:
    """The native client's padded read length (kma_cli.cpp's pad_len)."""
    Lb = 128
    while Lb < mx:
        Lb = (Lb * 3 // 2 + 63) // 64 * 64
    return Lb


class Conn:
    """One connection, framed as kma_devclient.cpp frames it: an 8-byte
    little-endian header length, a JSON header of the meta and the
    arrays' (name, dtype, shape), then each array's bytes."""

    def __init__(self, sock_path: str, db: str, timeout: float = 300.0):
        self.s = socket.socket(socket.AF_UNIX)
        self.s.settimeout(timeout)
        self.s.connect(sock_path)
        real = os.path.realpath(db)
        ext = ".comp.b" if os.path.exists(real + ".comp.b") else ".b"
        st = os.stat(real + ext)
        self.send({"op": "hello", "db": real,
                   "sig": [ext, st.st_size, int(st.st_mtime)]})
        self.recv()

    def send(self, meta, arrays=()) -> None:
        hdr = json.dumps({"meta": meta, "arrays": [
            [n, a.dtype.str, list(a.shape)] for n, a in arrays]}).encode()
        self.s.sendall(HDR.pack(len(hdr)) + hdr)
        for _, a in arrays:
            self.s.sendall(memoryview(np.ascontiguousarray(a)).cast("B"))

    def _exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            r = self.s.recv_into(view[got:], n - got)
            if r == 0:
                raise EOFError("the daemon closed the connection")
            got += r
        return buf

    def recv(self):
        (n,) = HDR.unpack(bytes(self._exact(HDR.size)))
        hdr = json.loads(bytes(self._exact(n)))
        if not hdr["meta"].get("ok"):
            raise RuntimeError("daemon error: %s"
                               % hdr["meta"].get("err", "?"))
        out = {}
        for name, dt, shape in hdr["arrays"]:
            k = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            out[name] = np.frombuffer(self._exact(k), dt).reshape(shape)
        return out

    def close(self) -> None:
        self.s.close()


def dense_meta(pen) -> dict:
    return {"op": "dense", "M": int(pen["M"]), "MM": int(pen["MM"]),
            "U": int(pen["U"]), "W1": int(pen["W1"]), "exhaustive": False,
            "proxi_frac": None, "pipeline": True}


def tie_lists(r):
    """The reply's tie lists (None where a read has none)."""
    counts = np.asarray(r["counts"], np.int64)
    offs = np.cumsum(counts) - counts
    flat = r["flat"]
    return [flat[o: o + c] if h else None
            for h, o, c in zip(r["has"], offs, counts)]


def digest(r) -> str:
    h = hashlib.blake2b(digest_size=16)
    for name in ("scores", "modes", "over", "has", "counts", "flat"):
        h.update(np.ascontiguousarray(r[name]).tobytes())
    return h.hexdigest()


def main(params_path: str) -> int:
    sys.path.insert(0, ROOT)
    from kmabench import isolate
    with open(params_path) as f:
        P = json.load(f)
    mix = P["mix"]
    codes = np.load(P["codes"])
    offsets = np.load(P["offsets"])
    groups = np.load(P["groups"])
    n, L = mix["reads_per_request"], mix["isolate"]["read_bp"]
    pool = np.empty((mix["pool_requests"], n, L), np.uint8)
    for i in range(len(pool)):
        pool[i], _ = isolate.reads(codes, offsets, groups, mix["isolate"],
                                   n, np.random.default_rng([P["seed"], i]))
    np.save(P["pool"], pool)
    Lb = pad_len(L)
    sent = np.full((len(pool), n, Lb), 4, np.uint8)
    sent[:, :, :L] = pool
    warm_req = sent[0].copy()
    warm_req[0, :L] = isolate.palindrome(codes, offsets, L)
    lens = np.full(n, L, np.int32)
    meta = dense_meta(P["penalties"])
    depth = mix["depth"]
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "warm":
        return 1
    C = mix["clients"]
    conns = [Conn(P["sock"], P["db"]) for _ in range(C)]
    for c in conns:
        c.send(meta, [("codes", warm_req), ("lengths", lens)])
        c.send({"op": "flush"})
    for c in conns:
        c.recv()
        c.recv()
    print("warmed", flush=True)
    _, t0, t1 = sys.stdin.readline().split()
    t0, t1 = float(t0), float(t1)
    m = mix["check_reads_per_request"]
    units, checked, differ, errors = [], [], [0], []
    first, lock = {}, threading.Lock()

    def client(c):
        conn, inflight, seq = conns[c], collections.deque(), 0

        def finish():
            pid, s, a = inflight.popleft()
            r = conn.recv()
            b = time.perf_counter()
            units.append({"client": c, "seq": s, "pid": pid, "t0": a,
                          "t1": b, "reads": n})
            d = digest(r)
            with lock:
                if first.setdefault(pid, d) != d:
                    differ[0] += 1
            tids = tie_lists(r)
            rng = np.random.default_rng([P["seed"], 1 << 20, c, s])
            for i in rng.choice(n, m, replace=False).tolist():
                checked.append((pid, i, int(r["scores"][i]),
                                int(r["modes"][i]), bool(r["over"][i]),
                                [] if tids[i] is None
                                else tids[i].tolist()))

        try:
            while time.perf_counter() < t1:
                pid = (c + seq * C) % len(pool)
                inflight.append((pid, seq, time.perf_counter()))
                conn.send(meta, [("codes", sent[pid]), ("lengths", lens)])
                seq += 1
                while len(inflight) > depth:
                    finish()
            conn.send({"op": "flush"})
            while inflight:
                finish()
            conn.recv()
        except Exception as e:      # noqa: BLE001 - a failed request
            errors.append("client %d: %r" % (c, e))

    ths = [threading.Thread(target=client, args=(c,)) for c in range(C)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for c in conns:
        c.close()
    with open(P["out"], "w") as f:
        json.dump({"units": units, "checked": checked,
                   "differ": differ[0], "errors": errors}, f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
