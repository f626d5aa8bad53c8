"""One run of one cell of the benchmark: ``python3 kmabench/run.py
--workload NAME --seed N --seconds S --trace 0|1``.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``kmabench/configs/<config>.json``: the DB's generator, its seed, the
KMA flags) and a traffic mix (``kmabench/traffic/<traffic>.json``:
parameters that the general load it names, ``kmabench/loads/
<load>.py``, reads).  A per-layer metric is a reader of its own,
``kmabench/metrics/<name>.py``.  Adding a cell, a configuration, a mix
or a metric adds files and entries only.

The run:

1. builds, once a checkout, the native host side
   (``kma_tpu_torch.native_build``) and the configuration's DB
   (``dbgen``, ``kma_index``); later runs find both;
2. starts the port's daemon (``kma_tpu_torch.launch.start``: index
   read, dense image, ``warm()``'s graph captures) on the card and
   serves it from a thread on a socket under ``TMPDIR``, while the
   load makes its inputs from ``--seed``; the load then warms every
   shape it sends;
3. measures for ``--seconds``: the load's closed-loop clients run
   until the window's end, and what is in flight then is finished and
   counted (with ``--trace 1`` under ``torch.profiler``);
4. stops the daemon (a fault fails the run), reads the card's peak
   memory, frees the card, and holds a sample of the window's answers,
   drawn from the seed, against the plain reference
   (``reference.py``);
5. prints each number compared beside its limit on stderr, and as the
   last line of stdout one JSON object: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, ``breakdown`` and
   ``checks``.

No measurement runs without a CUDA card: with none, or fewer than the
cell asks for, the run exits 3 and prints no result.  Nor does it run
when a module named ``jax`` or ``kma_tpu`` (by the whole top-level
name: ``kma_tpu_torch`` is the port) is loaded at its end.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "kma_tpu")
#: seconds a partly traced window's profiler warms up before it records:
#: opened cold amid busy work it recorded nothing for 9-11 s on the card
TRACE_WARMUP_S = 15.0


class Fail(Exception):
    """The run cannot give a result; exits 1 (no card: 3)."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: str, name: str):
    """(bench, cell, config, mix) of the cell ``name``."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Fail("no BENCHMARK.json at %s" % root)
    bench = load_json(path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Fail("unknown workload %r (cells: %s)"
                   % (name, ", ".join(sorted(cells))))
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    cfg["name"] = cell["config"]
    mix = load_json(os.path.join(root, "kmabench", "traffic",
                                 cell["traffic"] + ".json"))
    mix["name"] = cell["traffic"]
    return bench, cell, cfg, mix


def cell_metrics(bench: Dict, cell: str, trace: bool):
    """The metrics ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def check_root(root: str) -> None:
    for need in ("kma_tpu_torch", "native"):
        if not os.path.isdir(os.path.join(root, need)):
            raise Fail("%s is not beside the benchmark at %s: the "
                       "benchmark measures that checkout's port"
                       % (need, root))


def cuda_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise Fail("no CUDA card: the benchmark measures the card only", 3)
    if torch.cuda.device_count() < chips:
        raise Fail("the cell asks for %d cards, %d present"
                   % (chips, torch.cuda.device_count()), 3)
    return torch.device("cuda:0")


class Tee(io.TextIOBase):
    """Writes to stderr and keeps a copy (the daemon's start split)."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, s):
        sys.__stderr__.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        sys.__stderr__.flush()


def start_split(text: str) -> Dict[str, float]:
    """{stage: seconds} of ``launch.start``'s line ``# kma_tpu_torch run:
    daemon start T s (CUDA init a, kernel load b, ...)``."""
    for line in text.splitlines():
        if "daemon start" in line and "(" in line:
            inner = line[line.index("(") + 1: line.rindex(")")]
            out = {}
            for part in inner.split(","):
                name, _, v = part.strip().rpartition(" ")
                out[name] = float(v)
            return out
    return {}


def serve(srv, sock: str):
    """Serve ``srv`` on ``sock`` from a thread; (thread, errors)."""
    up, died = threading.Event(), []

    def run():
        try:
            srv.serve(sock_path=sock, ready_cb=up.set)
        except BaseException as e:    # noqa: BLE001 - reported below
            died.append(e)
            up.set()

    th = threading.Thread(target=run, name="kmabench-devserve", daemon=True)
    th.start()
    if not up.wait(120) or died:
        raise Fail("the daemon did not come up: %r" % (died or "timeout"))
    return th, died


def stop(srv, db: str, sock: str, th, died) -> None:
    from kma_tpu_torch.devserve import DevClient
    cli = DevClient.connect(db, sock_path=sock)
    if cli is None:
        raise Fail("cannot reach the daemon to stop it")
    cli.stop()
    th.join(timeout=120)
    if th.is_alive() or died:
        raise Fail("the daemon did not stop cleanly: %r"
                   % (died or "still running"))
    if srv.faults:
        raise Fail("the daemon faulted: %s" % srv.fault_line())


def run(argv: List[str], root: Optional[str] = None, device=None,
        batch: Optional[int] = None, fault=None,
        t_proc: Optional[float] = None) -> Dict:
    """One run; returns the result object (``main`` prints it).
    ``device``, ``batch`` and ``fault`` are for the CPU tests alone: a
    device other than a card, the daemon's rows a batch, and a function
    given the daemon after its start that breaks it underneath."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    ap = argparse.ArgumentParser(prog="kmabench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = root or os.path.dirname(HERE)
    check_root(root)
    bench, cell, cfg, mix = find_cell(root, a.workload)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    device = (cuda_device(cell["chips"]) if device is None
              else torch.device(device))
    from kma_tpu_torch import launch, native_build
    from . import dbgen
    from .trace import Window

    work = tempfile.mkdtemp(prefix="kmabench_")
    os.environ["KMA_DEVSERVE_DIR"] = os.path.join(work, "sock")
    gen = None
    try:
        built = native_build.build_all()
        if not built.get("libkma_io.so") or not os.access(
                native_build.CLI_BIN, os.X_OK):
            raise Fail("the native host side did not build: %s" % built)
        db = dbgen.prepare(cfg, os.path.join(root, "kmabench", "cache"),
                           log=say)
        load = importlib.import_module("kmabench.loads."
                                         + mix["load"])
        ctx = SimpleNamespace(
            work=work, seed=a.seed % (1 << 64), trace=bool(a.trace),
            cfg=cfg, mix=mix, db=db, device=device,
            sock=os.path.join(work, "sock", "devserve.sock"))
        gen = load.Load(ctx)
        gen_err: List[BaseException] = []

        def make():
            try:
                gen.prepare()
            except BaseException as e:    # noqa: BLE001 - re-raised
                gen_err.append(e)

        th_gen = threading.Thread(target=make, name="kmabench-inputs")
        th_gen.start()
        tee = Tee()
        try:
            with contextlib.redirect_stderr(tee):
                srv = launch.start(db["prefix"], device=device, batch=batch)
        finally:
            th_gen.join()
        if gen_err:
            raise gen_err[0]
        split = start_split(tee.buf.getvalue())
        if cfg.get("image") and srv.scanner_kind != cfg["image"]:
            raise Fail("the daemon holds a %s image, not the %s image the "
                       "configuration states" % (srv.scanner_kind,
                                                 cfg["image"]))
        th_srv, died = serve(srv, ctx.sock)
        if fault is not None:
            fault(srv)
        gen.warm(srv)
        captures = graph_count(srv)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n_dense = [len(srv.dense_ms), None]
        prof = (Window(device, later=bool(mix.get("trace_seconds")))
                 if a.trace else None)

        def profiler_on():
            # the daemon's dense ms from here on carry the profiler's
            # cost: a mix that traces part of its window reads them
            # before it
            n_dense[1] = len(srv.dense_ms)

        if prof is not None and not mix.get("trace_seconds"):
            profiler_on()
            prof.start()
        t_start = time.perf_counter()
        setup_s = t_start - t_proc
        say("kmabench: set-up %.2f s" % setup_s)
        units, traced = measure(gen, prof, t_start, a.seconds, mix,
                                profiler_on)
        t_end = max([t_start] + [u["t1"] for u in units])
        dense_ms = list(srv.dense_ms[n_dense[0]:(
            n_dense[1] if mix.get("trace_seconds") else None)])
        if graph_count(srv) != captures:
            say("kmabench: the daemon captured %d step graphs inside the "
                "window" % (graph_count(srv) - captures))
        stop(srv, db["prefix"], ctx.sock, th_srv, died)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        kind = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else str(device))
        daemon = SimpleNamespace(dense_ms=dense_ms, build_s=srv.build_s,
                                 split=split)
        del srv
        launch.free_cards()
        t_ref = time.perf_counter()
        checks = gen.check()
        # the reference's blocks back to the card, for a next run in
        # this process (the tests')
        launch.free_cards()
        say("kmabench: window %.2f s, %d %s; checks %.2f s; dense op "
            "median %s ms over %d requests"
            % (t_end - t_start, len(units), mix["load"],
               time.perf_counter() - t_ref,
               "%.2f" % statistics.median(dense_ms) if dense_ms else "-",
               len(dense_ms)))
        res = SimpleNamespace(window_s=t_end - t_start, setup_s=setup_s,
                              daemon=daemon, trace=traced, load=gen,
                              device=device)
        metrics = {}
        for m in cell_metrics(bench, cell["name"], bool(a.trace)):
            if a.trace:
                v = reader(root, m["name"]).read(res)
            elif m["name"] == "setup_s":
                v = setup_s
            else:
                v = gen.end_to_end(m["name"], res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": kind, "count": cell["chips"],
               "memory_peak_bytes": int(peak)}
        # a request or sample that fails ends the run: none is counted
        out = {"correct": all(c["value"] <= c["limit"] for c in checks),
               "attempted": gen.attempted, "failed": 0,
               "metrics": metrics, "device": dev}
        if traced is not None:
            dev["busy_s"] = traced["busy_s"]
            dev["window_s"] = traced["window_s"]
            out["breakdown"] = traced["breakdown"]
        out["checks"] = {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]} for c in checks}
        return out
    except (RuntimeError, OSError) as e:
        raise Fail("%s: %s" % (type(e).__name__, e)) from e
    finally:
        if gen is not None:
            gen.close()
        shutil.rmtree(work, ignore_errors=True)


def measure(gen, prof, t_start: float, seconds: float, mix: Dict,
            profiler_on):
    """Run the load's window from ``t_start`` for ``seconds``, under
    ``prof`` if given: (its units, the traced window or None).  The
    trace (started before ``t_start``) covers the window up to the last
    unit's end; with the mix's
    ``trace_seconds`` (a mix whose window holds more device events than
    a run can read back in time) its last ``trace_seconds`` before the
    nominal end alone: the profiler starts ``TRACE_WARMUP_S`` before
    them in its warm-up (device tracing primed, nothing kept), records
    from then on, and is read once every client has finished.
    ``profiler_on()`` is called as the profiler starts."""
    trace_seconds = mix.get("trace_seconds")
    if prof is None:
        return gen.window(t_start, t_start + seconds), None
    if not trace_seconds:
        units = gen.window(t_start, t_start + seconds)
        t_end = max([t_start] + [u["t1"] for u in units])
        return units, prof.stop(t_start, t_end, gen.label)
    out: List = []

    def window():
        try:
            out.append(gen.window(t_start, t_start + seconds))
        except BaseException as e:    # noqa: BLE001 - re-raised below
            out.append(e)

    th = threading.Thread(target=window, name="kmabench-window")
    th.start()
    t0 = t_start + seconds - trace_seconds
    time.sleep(max(0.0, t0 - TRACE_WARMUP_S - time.perf_counter()))
    profiler_on()
    prof.start()
    time.sleep(max(0.0, t0 - time.perf_counter()))
    prof.record()
    th.join()
    if isinstance(out[0], BaseException):
        raise out[0]
    return out[0], prof.stop(t0, t_start + seconds, gen.label)


def reader(root: str, name: str):
    """The per-layer metric ``name``'s reader,
    ``kmabench/metrics/<name>.py``, else that of its name up to the
    first dot (one reader for ``dense_op_ms.requests`` and
    ``dense_op_ms.samples``)."""
    d = os.path.join(root, "kmabench", "metrics")
    path = os.path.join(d, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(d, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "kmabench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def graph_count(srv) -> int:
    """Step graphs the daemon has captured (0 where it runs eager)."""
    return sum(sum(g.captures.values())
               for g in (srv.graphs, srv.chain_graphs) if g is not None)


def main(argv: List[str], t_proc: Optional[float] = None) -> int:
    try:
        out = run(argv, t_proc=t_proc)
    except Fail as e:
        say("kmabench: FAILED: %s" % e)
        return e.code
    bad = forbidden_modules()
    if bad:
        say("kmabench: FAILED: the run loaded %s" % ", ".join(bad))
        return 1
    for name, c in out["checks"].items():
        say("check %s %s limit %s" % (name, c["value"], c["limit"]))
    print(json.dumps(out), flush=True)
    return 0
