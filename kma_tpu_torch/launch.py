"""A daemon that lives for one run of ``bin/kma``: the device route of
``python -m kma_tpu_torch`` (``cli.py``, which decides ``-device``).

The JAX package builds its device scanners in-process when no daemon is
live; the port's counterpart is this launcher.  ``start`` builds and
warms a ``TorchDevServer`` on the DB of ``-t_db`` in its own process;
``serve_run`` serves it from a thread on a socket in a private temporary
directory, runs ``bin/kma`` as a child process whose environment alone
gains ``KMA_DEVSERVE_SOCKET`` (both CLIs attach to it) and the card's
figures the caller left unset (``envelope.py``), then stops the
daemon and removes the directory.  It returns the child's code, and
prints on stderr the requests the daemon served by op, its device and
its faults, where the dense requests' time went and why the card
idled (``tracing.span_line``), then its kernel launches during the run,
so a run the device did not serve is visible.

Nothing hides the device: ``start`` raises when no daemon can be built
(no card, a DB both scanners refuse), and a serve thread that died, or
a daemon op that faulted (the clients' host then finished the run at
parity), makes the exit code non-zero whatever the child's.
"""

from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Mapping, Optional

import torch

from . import envelope, tracing
from .device import DeviceLike, resolve, resolve_devices
from .devserve import (DevClient, TorchDevServer, fault_line,
                       kernel_launches, reset_kernel_launches)
from .mapping.scan_dense import DEFAULT_BATCH
from .ops import _build

#: the ops the exit line always names; any other op served is added
REPORTED_OPS = ("dense", "chain", "nw_qext")
SERVE_THREAD = "kma_tpu_torch-run-devserve"


def request_line(srv: TorchDevServer) -> str:
    """``dense 10, chain 0, nw_qext 1 requests on cuda:0, graphs 2
    (replays 40), chain graphs 2 (replays 0), pieces nw_qext 1, faults
    0``, or ``..., faults dense 2 (RuntimeError('...'))``
    (``fault_line``).  ``graphs N (replays M)``, where the dense op
    replays graphs (``srv.graphs``: a dense image, sharded or not, or
    the pair-stream image on cards): N keys of the scan step captured, M
    batches replayed from them; ``chain graphs`` the same of the chain
    op (``srv.chain_graphs``: a dense image's on a card); ``pieces``,
    where an NW or pileup op ran: the pieces each ran in (more than its
    requests where one passed the ops headroom)."""
    ops = list(REPORTED_OPS) + sorted(
        op for op, n in srv.requests.items()
        if n and op not in REPORTED_OPS + ("hello", "dense_pipelined"))
    # bench_torch.py passes a namespace of the run's counts, with no
    # chain graphs
    graphs = "".join(
        "%s %d (replays %d), " % (name, sum(g.captures.values()),
                                  sum(g.replays.values()))
        for name, g in (("graphs", srv.graphs),
                        ("chain graphs", getattr(srv, "chain_graphs", None)))
        if g is not None)
    pieces = getattr(srv, "op_pieces", None)
    if pieces:
        graphs += "pieces %s, " % ", ".join(
            "%s %d" % kv for kv in sorted(pieces.items()))
    return "%s requests on %s, %s%s" % (", ".join(
        "%s %d" % (op, srv.requests[op]) for op in ops), srv.device,
        graphs, fault_line(srv.faults, srv.first_fault))


def start(db: str, device: DeviceLike = None,
          devices: Optional[List[DeviceLike]] = None,
          batch: Optional[int] = None,
          setup_s: Optional[float] = None) -> TorchDevServer:
    """A warmed daemon on ``db``, on ``device`` (None: the CUDA card,
    raising without one) or sharded over ``devices``, as
    ``TorchDevServer`` places it; NotImplementedError for a DB both
    scanners refuse.  Prints where its start went: ``setup_s`` (the
    caller's time before this call: torch's import, the decision), the
    cards' CUDA context, the kernel library's load, the index read, the
    image build and the warm-up."""
    t0 = time.perf_counter()
    cards = [d for d in (resolve_devices(devices) if devices
                         else [resolve(device)]) if d.type == "cuda"]
    for d in cards:
        torch.zeros(1, device=d)
    t_cuda = time.perf_counter()
    if cards:
        _build.lib()
    t_lib = time.perf_counter()
    srv = TorchDevServer(db, batch=DEFAULT_BATCH if batch is None else batch,
                         device=device, devices=devices)
    t_srv = time.perf_counter()
    srv.warm(verbose=False)
    t_warm = time.perf_counter()
    reset_kernel_launches()
    for g in (srv.graphs, srv.chain_graphs):
        if g is not None:
            g.replays.clear()           # the run's replays, not warm()'s
    stages = ([("set-up", setup_s)] if setup_s is not None else []) + [
        ("CUDA init", t_cuda - t0), ("kernel load", t_lib - t_cuda),
        ("index read", t_srv - t_lib - srv.build_s),
        ("image build", srv.build_s), ("warm-up", t_warm - t_srv)]
    print("# kma_tpu_torch run: daemon start %.2f s (%s)" % (
        sum(s for _, s in stages),
        ", ".join("%s %.2f" % kv for kv in stages)), file=sys.stderr)
    return srv


def free_cards() -> None:
    """Give the cards back the memory of a daemon dropped unserved."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_run(srv: TorchDevServer, db: str, cmd: List[str],
              env: Mapping[str, str]) -> int:
    """Run ``cmd`` with ``srv`` served on a private socket named in the
    child's environment alone, beside the card's figures ``env`` leaves
    unset (``envelope.child_env``); then stop the daemon.  Returns the
    child's exit code, or 1 when it exited 0 but the daemon faulted or
    died."""
    print("# kma_tpu_torch run: %s" % envelope.figures_line(env),
          file=sys.stderr)
    env = dict(env, **envelope.child_env(env))
    sock_dir = tempfile.mkdtemp(prefix="kma_run_")
    sock = os.path.join(sock_dir, "devserve.sock")
    up, died = threading.Event(), []

    def serve():
        try:
            srv.serve(sock_path=sock, ready_cb=up.set)
        except BaseException as e:
            died.append(e)
            up.set()

    th = threading.Thread(target=serve, name=SERVE_THREAD, daemon=True)
    th.start()
    rc = 1
    t0 = t1 = time.perf_counter()
    try:
        up.wait()
        if not died:
            rc = subprocess.run(
                cmd, env=dict(env, KMA_DEVSERVE_SOCKET=sock)).returncode
    finally:
        t1 = time.perf_counter()
        cli = DevClient.connect(db, sock_path=sock) if th.is_alive() \
            else None
        if cli is not None:
            cli.stop()
        th.join(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    print("# kma_tpu_torch run: child %.2f s, daemon stop %.2f s"
          % (t1 - t0, time.perf_counter() - t1), file=sys.stderr)
    print("# kma_tpu_torch run: %s" % request_line(srv), file=sys.stderr)
    print("# kma_tpu_torch run: %s" % tracing.span_line(srv.spans),
          file=sys.stderr)
    print("# kma_tpu_torch run: kernel launches %s" % ", ".join(
        "%s %d" % kv for kv in kernel_launches().items()), file=sys.stderr)
    if died or th.is_alive():
        print("# kma_tpu_torch run: the daemon failed: %r"
              % (died[0] if died else "did not stop"), file=sys.stderr)
        return rc or 1
    if srv.faults:
        print("# kma_tpu_torch run: the card failed the run: %s; the host "
              "took its work over" % srv.fault_line(), file=sys.stderr)
        return rc or 1
    return rc
