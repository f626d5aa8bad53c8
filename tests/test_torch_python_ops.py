"""``cli.python_ops``, the port's copy of the daemon clients
``kma_tpu.pipeline.run_kma`` builds, held against a CPU daemon.

Each command line the native CLI hands to the Python pipeline runs
through the JAX package's CLI under ``-device on`` against
``TorchDevServer`` on the CPU, in the environment a served child gets:
the ops the daemon sees must be a subset of ``python_ops``, the output
equal to ``-device off``'s.  Where ``-device auto`` decides "host" the
daemon must see no request, and ``python -m kma_tpu_torch`` under auto
(no daemon built) must write the bytes ``-device off`` writes.  A
DB past the dense budget gets the pair-stream image, which refuses the
chain op: a run that may send ``chain`` goes to the host under auto at
parity and exits 1 under ``on`` before any child starts, while a
``-1t1`` run is still served."""

import functools
import os
import subprocess

import pytest

jax = pytest.importorskip("jax")

from kma_tpu.cli.main import main as jax_main
from kma_tpu_torch import cli, devserve, envelope, launch

from test_torch_devserve import (REPO, _same_outputs, daemon,  # noqa: F401
                                 disk_db, pairs)
from test_torch_launch import (_no_daemon_left, _requests,  # noqa: F401
                               private_tmp)

KMA = str(REPO / "bin" / "kma")
#: requests that carry no work
NOT_OPS = ("hello", "dense_pipelined")

#: (inputs and options before "-t_db", the caller's environment, whether
#: bin/kma would run the Python pipeline with no native CLI, the route
#: -device auto takes over the threshold, the ops the served run must
#: send); {S} 60 reads of 100 bp, {L} those and 6 reads of 500 bp, {P1}
#: {P2} 40 pairs of 2 x 100 bp, {I} the pairs interleaved.  An SE run
#: with no -proxi and no -hmm goes through the fused driver, which sends
#: nothing, where the native libraries are built and every file is FASTQ;
#: -device auto does not count on that, so those runs are served with no
#: op to send (KMA_TPU_NO_FUSED=1 shows the chain requests of the unfused
#: path it allows for).  SE reads under -proxi may reach the NW pre-pass
#: (a read over 256 bp), so they are served whatever their lengths
RUN_CASES = {
    "pe_hmm": ("-ipe {P1} {P2} -hmm", {}, False, "host", set()),
    "int_hmm": ("-int {I} -hmm", {}, False, "host", set()),
    "se_proxi": ("-i {S} -proxi 0.9", {}, False, "on", set()),
    "pe_proxi": ("-ipe {P1} {P2} -proxi 0.9", {}, False, "host", set()),
    "ont": ("-i {S} -ont", {}, False, "on", set()),
    "proxi_mem_mode_long": ("-i {L} -proxi 0.9 -mem_mode", {}, False,
                            "host", set()),
    "proxi_long_nw_off": ("-i {L} -proxi 0.9", {"KMA_TPU_NW": "off"}, False,
                          "host", set()),
    "stale_native_cli_ipe_hmm": ("-ipe {P1} {P2} -hmm", {}, True, "host",
                                 set()),
    "se_proxi_minus_1": ("-i {S} -proxi -1", {}, False, "on", set()),
    "se_proxi_minus_1_unfused": ("-i {S} -proxi -1",
                                 {"KMA_TPU_NO_FUSED": "1"}, False, "on",
                                 {"chain"}),
    "proxi_long": ("-i {L} -proxi 0.9", {}, False, "on", {"nw_qext"}),
    "ont_long": ("-i {L} -ont", {}, False, "on", {"nw_qext"}),
    "ipe_ex_mode": ("-ipe {P1} {P2} -ex_mode", {}, False, "on", {"chain"}),
    "i_and_ipe_hmm": ("-i {S} -ipe {P1} {P2} -hmm", {}, False, "on",
                      {"chain"}),
    "stale_native_cli_default": ("-i {S}", {}, True, "on", set()),
    "stale_native_cli_hmm": ("-i {S} -hmm", {}, True, "on", {"chain"}),
}


@pytest.fixture(scope="module")
def inputs(disk_db, pairs, tmp_path_factory):  # noqa: F811
    """The files of RUN_CASES."""
    _, reads = disk_db
    d = tmp_path_factory.mktemp("python_ops")
    lines = open(reads).read().splitlines(True)
    short = str(d / "short.fq")
    with open(short, "w") as f:
        f.writelines(lines[:4 * 60])
    inter = str(d / "inter.fq")
    a, b = (open(p).read().splitlines(True) for p in pairs)
    with open(inter, "w") as f:
        for i in range(0, len(a), 4):
            f.writelines(a[i:i + 4] + b[i:i + 4])
    return dict(S=short, L=reads, P1=pairs[0], P2=pairs[1], I=inter)


def _child_env(environ):
    """What ``cli.run`` gives a served child: the card's figures and
    KMA_TPU_PILEUP=off where the caller left them unset."""
    env = dict(environ)
    env.setdefault("KMA_TPU_PILEUP", "off")
    env.update(envelope.child_env(env))
    return env


def _seen(before, after):
    return {op for op in after if op not in NOT_OPS
            and after[op] > before.get(op, 0)}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_ops_seen_within_python_ops(case, daemon, inputs,  # noqa: F811
                                    tmp_path, private_tmp, capfd,
                                    monkeypatch):
    srv, prefix = daemon
    flags, environ, stale, route, sent = RUN_CASES[case]
    for var in ("KMA_DEV_CHAIN", "KMA_TPU_SCAN_MAX_MB", "KMA_TPU_PILEUP",
                "KMA_TPU_NO_FUSED", "KMA_TPU_NW"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cli, "native_cli_ready", lambda: not stale)
    args = flags.format(**inputs).split() + ["-t_db", prefix]
    env = _child_env(dict(os.environ, **environ))
    child_only = [k for k in env if k not in os.environ and k not in environ]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a = cli.parse_map_args(args + ["-o", str(tmp_path / "x")])
    assert cli.native_run(cli.on_argv(a.argv, a)) is None
    ops = cli.python_ops(a, env)
    on, why = cli.decide(a, lambda: True,
                         dict(env, KMA_TPU_DEVICE_AUTO_MB="0"))
    assert on == (route == "on"), why
    # served under -device on: what the daemon sees, against the copy
    out_on, out_off = str(tmp_path / "on"), str(tmp_path / "off")
    before = dict(srv.requests)
    capfd.readouterr()
    assert jax_main(args + ["-o", out_on, "-device", "on"]) in (0, None)
    err = capfd.readouterr().err
    assert "# device: using devserve session" in err
    assert "devserve lost" not in err and "pre-pass failed" not in err
    seen = _seen(before, srv.requests)
    assert seen <= ops, (seen, ops)
    assert not srv.faults
    assert seen == sent
    # the fused driver's copy, once the run has built its libraries
    assert seen <= cli.python_ops(a, env, cli.fused_driver(a, env))
    assert jax_main(args + ["-o", out_off, "-device", "off"]) in (0, None)
    _same_outputs(out_on, out_off)
    if route == "on":
        return
    # decided "host": no daemon built, the host's bytes
    for k in child_only:
        monkeypatch.delenv(k)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")

    def refuse(*_a, **_k):
        raise AssertionError("a daemon was built")
    monkeypatch.setattr(launch, "start", refuse)
    out_auto = str(tmp_path / "auto")
    capfd.readouterr()
    assert cli.run(args + ["-o", out_auto], device="cpu", batch=32) == 0
    err = capfd.readouterr().err
    assert "# kma_tpu_torch: -device auto -> host (input " in err
    assert "the Python pipeline sends the card no op" in err
    assert "# device:" not in err and "requests on" not in err
    _same_outputs(out_auto, out_off)
    _no_daemon_left(private_tmp)


# -- the pair-stream image ----------------------------------------------------

@pytest.fixture
def pair_stream(monkeypatch):
    """``TorchDevServer`` builds the pair-stream image: the dense image's
    budget is one byte."""
    monkeypatch.setattr(devserve, "dense_image", functools.partial(
        devserve.dense_image, mem_budget_bytes=1))


def _host_run(args, out):
    r = subprocess.run([KMA] + args + ["-o", out, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mode", ["default_unfused", "hmm", "ck_1t1", "ipe",
                                  "1t1", "default_fused"])
@pytest.mark.parametrize("device", ["auto", "on"])
def test_pair_stream_image_and_a_chain_client(mode, device, disk_db,  # noqa: F811,E501
                                              inputs, pair_stream, tmp_path,
                                              private_tmp, capfd,
                                              monkeypatch):
    """Python-pipeline runs that may send ``chain`` (the unfused default
    mode, -hmm, -ck -1t1, the fused -ipe path) against a DB on the
    pair-stream image: under auto the daemon is dropped and bin/kma runs
    on the host, its output -device off's; under on the run exits 1
    before any child starts, naming the refusal.  -1t1 sends only
    ``dense``, and the default mode under -ex_mode (which the native CLI
    hands over) goes through the fused driver, which sends nothing: both
    are served under both, at parity."""
    prefix, _ = disk_db
    for var in ("KMA_DEV_CHAIN", "KMA_TPU_SCAN_MAX_MB", "KMA_TPU_PILEUP",
                "KMA_TPU_NO_FUSED"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    monkeypatch.setattr(cli, "native_cli_ready", lambda: False)
    args = {"default_unfused": ["-i", inputs["L"]],
            "hmm": ["-i", inputs["L"], "-hmm"],
            "ck_1t1": ["-i", inputs["L"], "-ck", "-1t1"],
            "ipe": ["-ipe", inputs["P1"], inputs["P2"]],
            "1t1": ["-i", inputs["L"], "-1t1"],
            "default_fused": ["-i", inputs["L"], "-ex_mode"]}[mode] \
        + ["-t_db", prefix]
    if mode == "default_unfused":
        monkeypatch.setenv("KMA_TPU_NO_FUSED", "1")
    served = mode in ("1t1", "default_fused")
    if mode == "default_fused":
        # the libraries the fused driver loads, built as run_kma builds them
        from kma_tpu import run_native
        from kma_tpu.io import native_io
        assert native_io.get_lib() is not None
        assert run_native.get_lib() is not None
    argv = args + ["-o", str(tmp_path / "dev")] + (
        ["-device", "on"] if device == "on" else [])
    a = cli.parse_map_args(argv)
    chain = "chain" in cli.python_ops(a, os.environ,
                                      cli.fused_driver(a, os.environ))
    assert chain == (not served)
    assert (cli.chain_refusal(a, os.environ) is None) == served
    stub_calls = []
    real_child = cli.child
    monkeypatch.setattr(cli, "child", lambda *x, **k: stub_calls.append(x)
                        or real_child(*x, **k))
    capfd.readouterr()
    rc = cli.run(argv, device="cpu", batch=32)
    err = capfd.readouterr().err
    assert "# device scanner: dense membership over budget" in err
    _no_daemon_left(private_tmp)
    if served:
        assert rc == 0, err
        req = _requests(err)
        assert (req.get("dense", 0) >= 1) == (mode == "1t1"), req
        assert req.get("chain", 0) == 0, req
        assert "pair-stream image" not in err
    elif device == "on":
        assert rc == 1
        assert "# kma_tpu_torch run: -device on cannot serve this run: " in err
        assert "the image refuses the chain op" in err
        assert stub_calls == [] and "requests on" not in err
        assert not os.path.exists(str(tmp_path / "dev.res"))
        return
    else:
        assert rc == 0, err
        dec = [ln for ln in err.splitlines()
               if ln.startswith("# kma_tpu_torch: -device auto -> ")]
        assert dec[0].startswith("# kma_tpu_torch: -device auto -> on (")
        assert dec[1].startswith("# kma_tpu_torch: -device auto -> host (")
        assert "on the pair-stream image of %s: the image refuses the " \
            "chain op" % prefix in dec[1]
        assert "requests on" not in err
        assert len(stub_calls) == 1 and "-device" not in stub_calls[0][0]
    _host_run(args, str(tmp_path / "host"))
    _same_outputs(str(tmp_path / "dev"), str(tmp_path / "host"),
                  frag=mode != "ck_1t1")
