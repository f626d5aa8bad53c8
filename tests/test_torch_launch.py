"""``python -m kma_tpu_torch run``: a ``-device on`` run of ``bin/kma``
served by a daemon the launcher starts for it, here on the CPU.

``-1t1`` and the native default mode (``KMA_DEV_CHAIN=force``) must be
byte-identical to ``-device off`` (``.frag.gz`` after decompression),
with dense or chain requests served; afterwards no socket directory and
no serve thread are left.  Arguments without ``-t_db``, and under
``-device on`` a DB both scanners refuse, give a non-zero exit and no
child run; a failing child's exit code is passed on."""

import os
import re
import stat
import subprocess
import tempfile
import threading

import pytest

pytest.importorskip("jax")

from kma_tpu.cli.main import index_main
from kma_tpu_torch import cli, envelope, launch
from kma_tpu_torch.__main__ import main as torch_main

from test_torch_devserve import (REPO, _same_outputs, disk_db,  # noqa: F401
                                 native_cli)

KMA = str(REPO / "bin" / "kma")


def _requests(err):
    """{op: requests} of the launcher's exit line."""
    line = [ln for ln in err.splitlines()
            if ln.startswith("# kma_tpu_torch run: ") and "requests on" in ln]
    assert len(line) == 1, err
    body = line[0].split(": ", 1)[1].split(" requests on ")[0]
    return {op: int(n) for op, n in
            (item.split() for item in body.split(", "))}


@pytest.fixture
def private_tmp(tmp_path, monkeypatch):
    """The launcher's socket directory goes under tmp_path/t."""
    d = tmp_path / "t"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _no_daemon_left(d):
    assert os.listdir(d) == []
    assert not [t for t in threading.enumerate()
                if t.name == launch.SERVE_THREAD and t.is_alive()]


@pytest.mark.parametrize("mode", ["1t1", "default"])
def test_run_matches_device_off(mode, disk_db, native_cli,  # noqa: F811
                                tmp_path, private_tmp, capfd, monkeypatch):
    prefix, reads = disk_db
    args = ["-i", reads, "-t_db", prefix] + (["-1t1"] if mode == "1t1"
                                             else [])
    if mode == "default":
        monkeypatch.setenv("KMA_DEV_CHAIN", "force")
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    capfd.readouterr()
    assert cli.run(args + ["-o", out_dev, "-device", "on"],
                      device="cpu", batch=32) == 0
    err = capfd.readouterr().err
    assert "# device: using devserve session" in err
    assert "devserve lost" not in err
    served = _requests(err)
    assert served["dense" if mode == "1t1" else "chain"] > 0
    _no_daemon_left(private_tmp)
    r = subprocess.run([KMA] + args + ["-o", out_host, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_dev, out_host)


@pytest.mark.parametrize("args", [
    ["-i", "r.fq", "-o", "out", "-device", "on"],
    ["-i", "r.fq", "-t_db", "db", "-o", "out"],
    ["-i", "r.fq", "-t_db", "db", "-o", "out", "-device", "off"],
    []])
def test_usage_errors_exit_1(args, tmp_path, capfd, monkeypatch):
    """No ``-t_db``: the usage and exit 1, no child run.  With one, under
    ``auto``'s threshold or ``-device off``, bin/kma runs with every
    argument unchanged and its exit code (1 here) is passed on."""
    stub = _stub_kma(tmp_path / "kma", 1)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.delenv("KMA_TPU_DEVICE_AUTO_MB", raising=False)
    assert cli.run(args, device="cpu") == 1
    assert torch_main(["run"] + args) == 1
    err = capfd.readouterr().err
    if "-t_db" in args:
        assert open(stub + ".args").read().split() == args
        assert "usage:" not in err
    else:
        assert "usage: python -m kma_tpu_torch" in err
        assert not os.path.exists(stub + ".args")


@pytest.fixture(scope="module")
def cmer_db(disk_db, tmp_path_factory):  # noqa: F811
    """The reads' DB indexed with homopolymer compression (-hc)."""
    prefix, _ = disk_db
    d = tmp_path_factory.mktemp("cmer")
    out = str(d / "db_hc")
    assert index_main(["-i", os.path.join(os.path.dirname(prefix),
                                          "db.fsa"), "-o", out, "-hc"]) == 0
    return out


def _stub_kma(path, rc):
    """A stand-in for bin/kma that records its arguments, its
    KMA_DEVSERVE_SOCKET, its KMA_TPU_PILEUP and each variable of the
    card's figures (``-`` when unset; the variable's name is the file's
    suffix), then exits ``rc``."""
    figures = "".join("echo \"${%s--}\" > \"%s.%s\"\n" % (f.name, path,
                                                            f.name)
                      for f in envelope.FIGURES if f.env)
    path.write_text("#!/bin/sh\necho \"$@\" > \"%s.args\"\n"
                    "echo \"$KMA_DEVSERVE_SOCKET\" > \"%s.sock\"\n"
                    "echo \"${KMA_TPU_PILEUP--}\" > \"%s.pileup\"\n"
                    "%sexit %d\n" % (path, path, path, figures, rc))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_refused_db_runs_no_child(cmer_db, disk_db, tmp_path,  # noqa: F811
                                  private_tmp, capfd, monkeypatch):
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)
    _, reads = disk_db
    rc = cli.run(["-i", reads, "-t_db", cmer_db, "-o",
                     str(tmp_path / "o"), "-1t1", "-device", "on"],
                    device="cpu", batch=32)
    assert rc != 0
    err = capfd.readouterr().err
    assert "no device daemon for" in err and "cmer" in err
    assert not os.path.exists(stub + ".args")
    _no_daemon_left(private_tmp)


@pytest.mark.parametrize("child_rc", [0, 3, 113])
def test_child_exit_code_passed_on(child_rc, disk_db, tmp_path,  # noqa: F811
                                   private_tmp, monkeypatch):
    """Every argument reaches the child unchanged; its environment
    alone gains the daemon's socket."""
    stub = _stub_kma(tmp_path / "kma", child_rc)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.delenv("KMA_DEVSERVE_SOCKET", raising=False)
    prefix, reads = disk_db
    args = ["-i", reads, "-t_db", prefix, "-o", str(tmp_path / "o"),
            "-1t1", "-device", "on", "-mem_mode"]
    assert cli.run(args, device="cpu", batch=32) == child_rc
    assert open(stub + ".args").read().split() == args
    sock = open(stub + ".sock").read().strip()
    assert re.fullmatch(re.escape(str(private_tmp)) + r"/kma_run_\w+/"
                        r"devserve\.sock", sock), sock
    assert "KMA_DEVSERVE_SOCKET" not in os.environ
    _no_daemon_left(private_tmp)


def test_dead_serve_thread_fails_the_run(disk_db, tmp_path,  # noqa: F811
                                         private_tmp, monkeypatch, capfd):
    """A daemon whose serve loop raises: no child run, exit 1."""
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)

    def broken(self, sock_path=None, ready_cb=None):
        raise OSError("cannot bind")

    monkeypatch.setattr(launch.TorchDevServer, "serve", broken)
    prefix, reads = disk_db
    assert cli.run(["-i", reads, "-t_db", prefix, "-o",
                       str(tmp_path / "o"), "-1t1", "-device", "on"],
                      device="cpu", batch=32) == 1
    assert "the daemon failed: OSError('cannot bind')" \
        in capfd.readouterr().err
    assert not os.path.exists(stub + ".args")
    _no_daemon_left(private_tmp)


# -- faults: a daemon op that raised fails the run ------------------------

KERNEL_ERROR = "run_score_rows: CUDA error 700"
NW_ERROR = "nw_band: CUDA error 2"


def _fault_line(err):
    """The launcher's line of a run the card failed."""
    line = [ln for ln in err.splitlines()
            if ln.startswith("# kma_tpu_torch run: the card failed")]
    assert len(line) == 1, err
    return line[0]


def _host_run(args, out):
    r = subprocess.run([KMA] + args + ["-o", out, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_dense_fault_fails_the_run(disk_db, native_cli,  # noqa: F811
                                   tmp_path, private_tmp, capfd,
                                   monkeypatch):
    """``python -m kma_tpu_torch -1t1 -device on`` whose daemon's
    run-scoring kernel raises: the native CLI's host takes over at
    parity (its output equals ``-device off``), and the run exits 1
    naming the op, the count and the first error."""
    from kma_tpu_torch.mapping import scan_dense

    def broken(*a, **k):
        raise RuntimeError(KERNEL_ERROR)

    srvs = []
    real_start = launch.start

    def start(*a, **k):
        srvs.append(real_start(*a, **k))     # warmed on the real kernel
        monkeypatch.setattr(scan_dense, "run_score_rows", broken)
        return srvs[-1]

    monkeypatch.setattr(launch, "start", start)
    prefix, reads = disk_db
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    capfd.readouterr()
    assert cli.run(args + ["-o", out_dev, "-device", "on"], device="cpu",
                   batch=32) == 1
    err = capfd.readouterr().err
    srv, = srvs
    n = srv.faults["dense"]
    assert n >= 1 and set(srv.faults) == {"dense"}
    assert srv.first_fault == repr(RuntimeError(KERNEL_ERROR))
    assert "devserve lost" in err
    want = "faults dense %d (%s)" % (n, srv.first_fault)
    assert want in _fault_line(err)
    assert [ln for ln in err.splitlines() if " requests on cpu, " in ln
            ][0].endswith(want)
    _no_daemon_left(private_tmp)
    _host_run(args, out_host)
    _same_outputs(out_dev, out_host)


def test_nw_qext_fault_fails_the_run(disk_db, tmp_path,  # noqa: F811
                                     private_tmp, capfd, monkeypatch):
    """The Python CLI's NW pre-pass against a daemon whose ``nw_qext``
    kernel raises: the host pre-pass takes over at parity, and
    ``serve_run`` returns 1 with the fault line."""
    import sys

    from kma_tpu.cli.main import main as jax_main
    from kma_tpu_torch import devserve

    def broken(*a, **k):
        raise RuntimeError(NW_ERROR)

    prefix, reads = disk_db
    srv = devserve.TorchDevServer(prefix, batch=32, device="cpu")
    monkeypatch.setattr(devserve, "nw_band_score_qext", broken)
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    env = dict(os.environ, KMA_TPU_NW="force", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    capfd.readouterr()
    rc = launch.serve_run(srv, prefix, [sys.executable, "-m", "kma_tpu"]
                          + args + ["-o", out_dev, "-device", "on"], env)
    err = capfd.readouterr().err
    assert rc == 1, err
    assert "# device: using devserve session" in err
    assert "device NW pre-pass failed" in err
    n = srv.faults["nw_qext"]
    assert n >= 1 and set(srv.faults) == {"nw_qext"}
    assert "faults nw_qext %d (%s)" % (n, repr(RuntimeError(NW_ERROR))) \
        in _fault_line(err)
    assert srv.requests["dense"] > 0
    _no_daemon_left(private_tmp)
    monkeypatch.setenv("KMA_TPU_NW", "off")
    assert jax_main(args + ["-o", out_host, "-device", "off"]) in (0, None)
    _same_outputs(out_dev, out_host)


def test_chain_refusal_is_not_a_fault(disk_db, native_cli,  # noqa: F811
                                      tmp_path, private_tmp, capfd,
                                      monkeypatch):
    """A pair-stream daemon refuses ``chain`` by design: the native
    default mode takes the host at parity and the run exits 0 with
    ``faults 0``."""
    from kma_tpu_torch import devserve
    prefix, reads = disk_db
    monkeypatch.setenv("KMA_TPU_DENSE_BUDGET_MB", "0")
    srv = devserve.TorchDevServer(prefix, batch=32, device="cpu")
    monkeypatch.delenv("KMA_TPU_DENSE_BUDGET_MB")
    assert srv.scanner_kind == "pair_stream"
    args = ["-i", reads, "-t_db", prefix]
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    env = dict(os.environ, KMA_DEV_CHAIN="force")
    capfd.readouterr()
    assert launch.serve_run(srv, prefix, [native_cli] + args
                            + ["-o", out_dev, "-device", "on"], env) == 0
    err = capfd.readouterr().err
    assert "devserve lost" in err
    assert srv.requests["chain"] >= 1 and not srv.faults
    assert [ln for ln in err.splitlines() if " requests on cpu, " in ln
            ][0].endswith(", faults 0")
    assert "the card failed" not in err
    _no_daemon_left(private_tmp)
    _host_run(args, out_host)
    _same_outputs(out_dev, out_host)


@pytest.mark.parametrize("faults,line", [
    ({}, "dense 3, chain 0, nw_qext 1 requests on cpu, faults 0"),
    ({"dense": 2, "nw_qext": 1},
     "dense 3, chain 0, nw_qext 1 requests on cpu, faults dense 2, "
     "nw_qext 1 (RuntimeError('run_score_rows: CUDA error 700'))")])
def test_request_line_names_the_faults(faults, line):
    from collections import Counter
    from types import SimpleNamespace
    srv = SimpleNamespace(
        requests=Counter(dense=3, nw_qext=1, hello=2, dense_pipelined=3),
        device="cpu", faults=Counter(faults),
        first_fault=repr(RuntimeError(KERNEL_ERROR)) if faults else None,
        graphs=None, chain_graphs=None)
    assert launch.request_line(srv) == line


def test_request_line_names_the_graphs():
    """A daemon whose dense op replays graphs names how many it captured
    and how many batches it replayed, then its chain op's the same,
    before its faults."""
    from collections import Counter
    from types import SimpleNamespace
    graphs = SimpleNamespace(captures=Counter(a=1, b=1),
                             replays=Counter(a=30, b=10))
    chain = SimpleNamespace(captures=Counter(c=1), replays=Counter(c=4))
    srv = SimpleNamespace(requests=Counter(dense=3, chain=4),
                          device="cuda:0", faults=Counter(),
                          first_fault=None, graphs=graphs,
                          chain_graphs=chain)
    assert launch.request_line(srv) == (
        "dense 3, chain 4, nw_qext 0 requests on cuda:0, graphs 2 "
        "(replays 40), chain graphs 1 (replays 4), faults 0")
    srv.chain_graphs = None          # a pair-stream daemon's
    assert launch.request_line(srv) == (
        "dense 3, chain 4, nw_qext 0 requests on cuda:0, graphs 2 "
        "(replays 40), faults 0")


def test_refusals_are_not_faults(disk_db):  # noqa: F811
    """A refusal answers ``ok: 0`` and counts nothing; any other error
    counts a fault of its op, the first error kept."""
    from kma_tpu_torch import devserve
    prefix, _ = disk_db
    srv = devserve.TorchDevServer(prefix, batch=32, device="cpu")
    for op, e in (("chain", devserve.ChainRefused("no dense index")),
                  ("nw", devserve.RowsRefused("t_len 5 exceeds"))):
        assert srv._error(op, e) == {"ok": 0, "err": repr(e)}
    assert not srv.faults and srv.first_fault is None
    first = RuntimeError(KERNEL_ERROR)
    for op, e in (("dense", first), ("dense", MemoryError()),
                  ("pileup", ValueError("bad"))):
        assert srv._error(op, e)["ok"] == 0
    assert srv.faults == {"dense": 2, "pileup": 1}
    assert srv.first_fault == repr(first)
    assert srv.fault_line() == "faults dense 2, pileup 1 (%r)" % first


@pytest.mark.parametrize("n_faults", [0, 2])
def test_hand_started_daemon_exits_1_after_a_fault(n_faults, disk_db,  # noqa: F811,E501
                                                   tmp_path, capfd,
                                                   monkeypatch):
    """``python -m kma_tpu_torch devserve`` prints its faults at stop and
    exits 1 if there were any."""
    from collections import Counter

    from kma_tpu_torch import devserve, tracing
    from kma_tpu_torch.device import resolve
    prefix, _ = disk_db
    device = resolve("cpu")

    class Served:
        fault_line = devserve.TorchDevServer.fault_line

        def __init__(self, db, batch):
            self.spans = tracing.Recorder(device)
            self.faults = Counter(dense=n_faults) if n_faults else Counter()
            self.first_fault = repr(RuntimeError(KERNEL_ERROR)) \
                if n_faults else None

        def warm(self, lengths):
            pass

        def serve(self):
            pass

    monkeypatch.setenv("KMA_DEVSERVE_DIR", str(tmp_path / "s"))
    monkeypatch.setattr(devserve, "TorchDevServer", Served)
    capfd.readouterr()
    assert devserve.devserve_main(["-t_db", prefix]) == int(n_faults > 0)
    want = "# devserve: faults %s" % (
        "dense 2 (%r)" % RuntimeError(KERNEL_ERROR) if n_faults else "0")
    assert want in capfd.readouterr().err
