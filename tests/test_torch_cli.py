"""``python -m kma_tpu_torch <kma args>``: the JAX package's command
line, with ``-device auto`` decided as ``kma_tpu`` decides it, except
where a served run would send the card no op.

The parser and the decision are held against ``kma_tpu.cli.main`` and
``kma_tpu.pipeline._device_enabled`` on a table of command lines,
thresholds and file sizes; the port departs from it exactly where a
served run would send the daemon no op (``cli.idle_reason``): the native
CLI would run the command line itself in a chain mode whose probes the
card's chain budget keeps on the host, or the Python pipeline would build
no client of the daemon for it (``cli.python_ops``, held against a CPU
daemon in tests/test_torch_python_ops.py).
Over the threshold a CPU daemon serves ``-1t1`` (dense), the native
default mode with ``KMA_DEV_CHAIN=force`` (chain) and ``-ipe -hmm``
(the Python pipeline's chain requests) at byte parity with ``-device
off``; the native default mode, ``-ipe`` and ``-hmm`` stay on the host,
and the same runs under ``-device on`` send the daemon no op; under the
threshold no daemon is built.  Only the ``-device`` value
of the child's command line changes; ``KMA_TPU_PILEUP=off`` goes to the
child exactly when ``auto``'s threshold is over 0.  Tool subcommands,
the spltDB, ``-Mt1``, ``-Sparse``, ``-s1`` and ``-s2`` flows start no
daemon; ``-mh`` and a bad ``-device`` value exit 1 with no child."""

import os
import random
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import kma_tpu.mapping.sparse
import kma_tpu.parallel.multihost
import kma_tpu.pipeline
from kma_tpu.cli.main import main as jax_main
from kma_tpu_torch import cli, launch
from kma_tpu_torch.__main__ import main as torch_main

from test_torch_devserve import (REPO, _same_outputs, disk_db,  # noqa: F401
                                 native_cli, pairs)
from test_torch_launch import (_no_daemon_left, _requests,  # noqa: F401
                               _stub_kma, cmer_db, private_tmp)

KMA = str(REPO / "bin" / "kma")
MB = 1 << 20


def _read(stub, what):
    return open("%s.%s" % (stub, what)).read().strip()


# -- the decision against the JAX package ----------------------------------

#: the flow function map_main calls -> the port's flow name
JAX_FLOWS = [(kma_tpu.pipeline, "run_kma", "map"),
             (kma_tpu.pipeline, "run_kma_spltdb", "spltdb"),
             (kma_tpu.pipeline, "run_kma_mt1", "mt1"),
             (kma_tpu.mapping.sparse, "run_sparse", "sparse"),
             (kma_tpu.pipeline, "run_step1", "step1"),
             (kma_tpu.pipeline, "run_step2", "step2"),
             (kma_tpu.parallel.multihost, "run_kma_multihost", "multihost")]
#: map_main returns before any flow runs
NO_FLOW = ("stop", "usage", "spltdb_print")

# {R} 3 MB, {r} 0.5 MB, {B} 300 MB (sparse files), {D} {E} DBs, {O} out
DECISION_CASES = {
    "1t1": "-i {R} -t_db {D} -o {O} -1t1",
    "default_mode_small": "-i {r} -t_db {D} -o {O}",
    "two_inputs": "-i {r} {R} -t_db {D} -o {O} -1t1",
    "big": "-i {B} -t_db {D} -o {O} -1t1",
    "stdin": "-i -- -t_db {D} -o {O} -1t1",
    "no_input": "-t_db {D} -o {O} -1t1",
    "missing_file": "-i {D}.nofile {R} -t_db {D} -o {O}",
    "ipe": "-ipe {r} {R} -t_db {D} -o {O}",
    "int": "-int {R} -t_db {D} -o {O} -hmm",
    "i_and_ipe": "-i {r} -ipe {r} {R} -o {O} -t_db {D}",
    "device_on": "-i {r} -t_db {D} -o {O} -1t1 -device on",
    "device_off": "-i {B} -t_db {D} -o {O} -1t1 -device off",
    "device_auto": "-i {R} -device auto -t_db {D} -o {O} -1t1",
    "device_twice": "-device off -i {R} -t_db {D} -o {O} -device auto",
    "dash_values": "-i {R} -t_db {D} -o {O} -proxi -0.9 -mrs 0.5 -bc 0.9",
    "optional_values": "-i {R} -sam -t_db {D} -bc -o {O} -vcf 2 -verbose",
    "presets": "-i {R} -t_db {D} -o {O} -mint2 -ont -ex_mode -ef",
    "spltdb_one_db": "-i {R} -t_db {D} -o {O} -spltDB",
    "spltdb": "-i {B} -t_db {D} {E} -o {O}",
    "t_db_twice": "-i {B} -t_db {D} -o {O} -t_db {E} -device on",
    "spltdb_print": "-i {R} -t_db {D} {E} -o {O} -spltDB",
    "mt1": "-i {B} -t_db {D} -o {O} -Mt1 2 -device on",
    "mt1_zero": "-i {B} -t_db {D} -o {O} -Mt1 0",
    "sparse": "-i {B} -t_db {D} -o {O} -Sparse",
    "s1": "-i {B} -t_db {D} -o {O} -s1",
    "s2": "-i {B} -t_db {D} -o {O} -s2 -device on",
    "mh": "-i {B} -t_db {D} -o {O} -mh host:5000,2,0",
    "mh_spltdb": "-i {B} -t_db {D} {E} -o {O} -mh host:5000,2,0",
    "mh_mt1": "-i {B} -t_db {D} -o {O} -Mt1 1 -mh host:5000,2,0",
    "version": "-i {B} -t_db {D} -v -o {O}",
    "invalid_option": "-i {B} -t_db {D} -o {O} -nosuchflag",
    "no_out": "-i {B} -t_db {D}",
}
#: KMA_TPU_DEVICE_AUTO_MB values (None: unset, 256 MB)
THRESHOLDS = [None, "0", "1", "2", "4", "-1", "x"]


#: the reason the decision line gives where the native CLI's chain
#: budget leaves its daemon idle
BUDGET = "%s: the card's figures keep its chain probes on the host, " \
    "KMA_TPU_SCAN_MAX_MB 0"
#: the reason it gives where the Python pipeline would send no op
NO_OP = "%s: the Python pipeline sends the card no op"
#: cases where the port keeps on the host what the JAX package sends to
#: the device, by the reason named: the native CLI runs them itself
#: (sequence files, options it parses, no -1t1, no active -proxi, no PE
#: with -hmm) in a chain mode whose probes the card's chain budget
#: (KMA_TPU_SCAN_MAX_MB 0) keeps on the host, or it hands them to the
#: Python pipeline, which builds no client of the daemon for them (-int
#: with -hmm: the unfused PE loop; -mint2 with -ont: a soft -proxi, no
#: dense stream, no NW pre-pass in mem_mode, -dense's pileup off); so a
#: served run would send the daemon no op
DEPARTS = {"default_mode_small": BUDGET % "default mode",
           "ipe": BUDGET % "-ipe", "i_and_ipe": BUDGET % "-ipe",
           "device_twice": BUDGET % "default mode",
           "int": NO_OP % "-int -hmm",
           "presets": NO_OP % "-mint2 -ont -ex_mode -ef"}


@pytest.fixture(scope="module")
def sized_files(tmp_path_factory):
    """Read files of 3 MB, 0.5 MB and 300 MB (sparse), each a FASTQ
    file to the native CLI's format sniff (its first byte '@')."""
    d = tmp_path_factory.mktemp("sized")
    files = {}
    for key, size in (("R", 3 * MB), ("r", MB // 2), ("B", 300 * MB)):
        p = d / ("reads_%s.fq" % key)
        with open(p, "wb") as f:
            f.write(b"@")
            f.truncate(size)
        files[key] = str(p)
    files.update(D=str(d / "db"), E=str(d / "db2"), O=str(d / "out"))
    return files


def _jax_decision(argv, monkeypatch):
    """(flow, device on) of ``python -m kma_tpu <argv>``, its flows
    stubbed: run_kma reports ``_device_enabled`` on the input it sums
    (pipeline.py:1516-1524)."""
    got = []

    def rec(name, fn_name):
        def flow(*args, **kw):
            if fn_name == "run_kma_spltdb" and kw.get("mh") is not None:
                name_ = "multihost"
            else:
                name_ = name
            on = False
            if fn_name == "run_kma":
                cfg = args[3]
                files = list(args[2] or []) + list(kw.get("pe_files") or []) \
                    + list(kw.get("int_files") or [])
                on = kma_tpu.pipeline._device_enabled(
                    cfg, cli.input_bytes(files))
            got.append((name_, on))
            return 0
        return flow

    for mod, fn_name, name in JAX_FLOWS:
        monkeypatch.setattr(mod, fn_name, rec(name, fn_name))
    jax_main(list(argv))
    return got[0] if got else (None, False)


@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_decision_matches_jax(case, sized_files, monkeypatch, capsys):
    """The port's flow and device decision equal the JAX package's for
    every threshold, with an accelerator backend and with the CPU, but
    in the DEPARTS cases: there, wherever the JAX package goes to the
    device, the port stays on the host and says why.  The port's default
    threshold is the card's (test_port_default_threshold); here it is
    pinned to the JAX package's 256 MB, which an unset or unreadable
    KMA_TPU_DEVICE_AUTO_MB means there."""
    monkeypatch.setattr(cli, "DEFAULT_AUTO_MB", 256)
    monkeypatch.setattr(cli, "native_cli_ready", lambda: True)
    for var in ("KMA_DEV_CHAIN", "KMA_TPU_SCAN_MAX_MB"):
        monkeypatch.delenv(var, raising=False)
    argv = DECISION_CASES[case].format(**sized_files).split()
    a = cli.parse_map_args(argv)
    departed = 0
    for thresh in THRESHOLDS:
        if thresh is None:
            monkeypatch.delenv("KMA_TPU_DEVICE_AUTO_MB", raising=False)
        else:
            monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", thresh)
        for backend, present in (("tpu", True), ("cpu", False)):
            monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
            flow, jax_on = _jax_decision(argv, monkeypatch)
            on, why = cli.decide(a, lambda p=present: p)
            where = (case, thresh, backend)
            if flow is None:
                assert a.flow in NO_FLOW, where
            else:
                assert a.flow == flow, where
            if case in DEPARTS and jax_on:
                assert not on, where
                assert why.endswith("; " + DEPARTS[case]), (where, why)
                departed += 1
            else:
                assert on == jax_on, where
    assert bool(departed) == (case in DEPARTS)
    capsys.readouterr()


# -- auto serves only a run that would send the card an op -----------------

#: the caller's chain budget in the reason
CALLER = "%s: the caller's KMA_TPU_SCAN_MAX_MB=%s keeps its chain probes " \
    "on the host"
#: (command line after "-i {R} -t_db {D} -o {O}" or with its own inputs,
#: environment, whether auto serves it, the reason a host decision names
#: after "input N MB >= 0 MB; "); {S} 100 bp reads, {L} 300 bp reads
IDLE_CASES = {
    "default": ("", {}, False, BUDGET % "default mode"),
    "ipe": ("-ipe {R} {r}", {}, False, BUDGET % "-ipe"),
    "int": ("-int {R}", {}, False, BUDGET % "-int"),
    "hmm": ("-hmm", {}, False, BUDGET % "-hmm"),
    "1t1": ("-1t1", {}, True, None),
    "1t1_hmm": ("-hmm -1t1", {}, True, None),
    "mint2_preset": ("-mint2", {}, True, None),
    "ipe_hmm": ("-ipe {R} {r} -hmm", {}, False, NO_OP % "-ipe -hmm"),
    "proxi": ("-proxi 0.9", {}, True, None),
    "proxi_minus_1": ("-proxi -1", {}, True, None),
    "ont_preset": ("-ont", {}, True, None),
    "sam": ("-sam", {}, False, BUDGET % "default mode"),
    "sam_digits": ("-sam 2 -tsv", {}, False, BUDGET % "default mode"),
    "python_only_flag": ("-ex_mode", {}, True, None),
    "bad_apm": ("-apm x", {}, True, None),
    "conclave_3": ("-ConClave 3", {}, True, None),
    "not_a_sequence_file": ("-i {Z}", {}, True, None),
    "gzipped_fastq": ("-i {G}", {}, False, BUDGET % "default mode"),
    "stdin": ("-i --", {}, True, None),
    "dev_chain_force": ("", {"KMA_DEV_CHAIN": "force"}, True, None),
    "dev_chain_other": ("", {"KMA_DEV_CHAIN": "on"}, False,
                        BUDGET % "default mode"),
    "scan_max_mb_8": ("-hmm", {"KMA_TPU_SCAN_MAX_MB": "8"}, True, None),
    "scan_max_mb_0": ("", {"KMA_TPU_SCAN_MAX_MB": "0"}, False,
                      CALLER % ("default mode", "0")),
    "scan_max_mb_text": ("", {"KMA_TPU_SCAN_MAX_MB": "x"}, False,
                         CALLER % ("default mode", "x")),
    # the Python pipeline's runs, decided by python_ops
    "pe_hmm": ("-ipe {S} {S} -hmm", {}, False, NO_OP % "-ipe -hmm"),
    "int_hmm": ("-int {S} -hmm", {}, False, NO_OP % "-int -hmm"),
    "i_and_ipe_hmm": ("-i {S} -ipe {S} {S} -hmm", {}, True, None),
    # SE reads may reach the NW pre-pass, whatever their lengths
    "se_proxi": ("-i {S} -proxi 0.9", {}, True, None),
    "se_proxi_gz": ("-i {Sz} -proxi 0.9", {}, True, None),
    "se_proxi_fasta": ("-i {Sa} -proxi 0.9", {}, True, None),
    "pe_proxi": ("-ipe {S} {S} -proxi 0.9", {}, False,
                 NO_OP % "-ipe -proxi 0.9"),
    "pe_proxi_long": ("-ipe {L} {L} -proxi 0.9", {}, False,
                      NO_OP % "-ipe -proxi 0.9"),
    "se_proxi_minus_1": ("-i {S} -proxi -1", {}, True, None),
    "pe_proxi_minus_1": ("-ipe {S} {S} -proxi -1", {}, True, None),
    "pe_proxi_minus_1_mem_mode": ("-ipe {S} {S} -proxi -1 -mem_mode", {},
                                  False, NO_OP % "-ipe -proxi -1 -mem_mode"),
    "ont": ("-i {S} -ont", {}, True, None),
    "ont_long": ("-i {L} -ont", {}, True, None),
    "asm_long_fasta": ("-i {La} -asm", {}, True, None),
    "ill": ("-i {S} -ill", {}, True, None),
    "mem_mode": ("-i {S} -mem_mode", {}, False,
                 BUDGET % "default mode"),
    "proxi_mem_mode_long": ("-i {L} -proxi 0.9 -mem_mode", {}, False,
                            NO_OP % "-proxi 0.9 -mem_mode"),
    "proxi_long": ("-i {L} -proxi 0.9", {}, True, None),
    "proxi_long_nw_off": ("-i {L} -proxi 0.9", {"KMA_TPU_NW": "off"}, False,
                          NO_OP % "-proxi 0.9"),
    "proxi_short_and_long": ("-i {S} {L} -proxi 0.9", {}, True, None),
    "proxi_stdin": ("-i -- -proxi 0.9", {}, True, None),
    "ipe_ex_mode": ("-ipe {S} {S} -ex_mode", {}, True, None),
    "ipe_hmm_dense_pileup": ("-ipe {S} {S} -hmm -dense",
                             {"KMA_TPU_PILEUP": "auto"}, True, None),
    "ipe_hmm_dense": ("-ipe {S} {S} -hmm -dense", {}, False,
                      NO_OP % "-ipe -hmm -dense"),
    "stale_native_cli_default": ("-i {S}", {}, True, None),
    "stale_native_cli_hmm": ("-i {S} -hmm", {}, True, None),
    "stale_native_cli_ipe": ("-ipe {S} {S}", {}, True, None),
    "stale_native_cli_ipe_hmm": ("-ipe {S} {S} -hmm", {}, False,
                                 NO_OP % "-ipe -hmm"),
}


def _idle_files(d, sized_files):
    """``sized_files`` and small real inputs under ``d``: {S} 100 bp and
    {L} 300 bp FASTQ reads, {Sz} {S} gzipped, {Sa} {La} FASTA records of
    two lines, {Z} not reads, {G} one gzipped FASTQ read."""
    import gzip as gz
    rng = random.Random(5)

    def fq(path, n, L, op=open):
        with op(path, "wt") as f:
            for i in range(n):
                s = "".join(rng.choice("ACGT") for _ in range(L))
                f.write("@r%d\n%s\n+\n%s\n" % (i, s, "I" * L))

    def fa(path, n, L):
        with open(path, "w") as f:
            for i in range(n):
                s = "".join(rng.choice("ACGT") for _ in range(L))
                f.write(">c%d\n%s\n%s\n" % (i, s[:L // 2], s[L // 2:]))

    files = dict(sized_files, **{k: str(d / v) for k, v in (
        ("S", "s.fq"), ("L", "l.fq"), ("Sz", "s.fq.gz"), ("Sa", "s.fa"),
        ("La", "l.fa"), ("Z", "z.txt"), ("G", "g.fq.gz"))})
    fq(files["S"], 20, 100)
    fq(files["L"], 20, 300)
    fq(files["Sz"], 20, 100, gz.open)
    fa(files["Sa"], 20, 256)
    fa(files["La"], 20, 258)
    with open(files["Z"], "w") as f:
        f.write("not reads\n")
    with gz.open(files["G"], "wt") as f:
        f.write("@r\nACGT\n+\nIIII\n")
    return files


@pytest.mark.parametrize("case", sorted(IDLE_CASES))
def test_auto_serves_a_run_only_with_an_op_to_send(case, sized_files,
                                                   tmp_path, monkeypatch):
    """``decide`` over the threshold: a command line the native CLI runs
    itself in a chain mode, its chain budget the card's 0 or the
    caller's 0, stays on the host with the reason named; so does one it
    hands to the Python pipeline (PE with -hmm, an active or -1 -proxi,
    an option it does not parse, a bad value, input that is not a
    sequence file, stdin, every run where bin/kma would not run the
    native CLI) where ``python_ops`` finds no op to send.  -1t1 (and the
    presets that set it), ``KMA_DEV_CHAIN=force``, a budget over 0 and
    a Python-pipeline run with an op are served.  The card is not asked
    about a run kept on the host."""
    monkeypatch.setattr(cli, "native_cli_ready",
                        lambda: not case.startswith("stale_"))
    flags, environ, served, reason = IDLE_CASES[case]
    files = _idle_files(tmp_path, sized_files)
    inputs = "" if flags.startswith(("-ipe", "-int", "-i ")) else "-i {R}"
    argv = ("%s %s -t_db {D} -o {O}" % (inputs, flags)).format(
        **files).split()
    a = cli.parse_map_args(argv)
    assert a.flow == "map"
    environ = dict(environ, KMA_TPU_DEVICE_AUTO_MB="0")
    asked = []
    on, why = cli.decide(a, lambda: asked.append(1) or True, environ)
    assert on == served, why
    assert bool(asked) == served
    if served:
        assert why == "input %s MB >= 0 MB" % why.split()[1]
    else:
        assert why == "input %s MB >= 0 MB; %s" % (why.split()[1],
                                                   reason), why
    if cli.native_run(cli.on_argv(argv, a)) is None:
        assert bool(cli.python_ops(a, environ)) == served
    # under the threshold, -device on and -device off nothing changed
    environ["KMA_TPU_DEVICE_AUTO_MB"] = "1000000"
    assert cli.decide(a, lambda: True, environ)[0] is False
    for device, want in (("on", True), ("off", False)):
        b = cli.parse_map_args(argv + ["-device", device])
        assert cli.decide(b, lambda: True, environ) == (want, None)


#: (command line before "-t_db", environment, whether run_kma surely maps
#: it with the fused driver: pipeline.py:1591-1609); {S} 100 bp FASTQ,
#: {Sz} gzipped, {Sa} FASTA
FUSED_CASES = {
    "se": ("-i {S}", {}, True),
    "se_gzipped": ("-i {Sz}", {}, True),
    "se_ex_mode": ("-i {S} -ex_mode", {}, True),
    "pe": ("-ipe {S} {S}", {}, True),
    "pe_and_se": ("-i {S} -ipe {S} {S}", {}, True),
    "proxi_minus_1": ("-i {S} -proxi -1", {}, True),
    "fasta": ("-i {Sa}", {}, False),
    "fastq_and_fasta": ("-i {S} {Sa}", {}, False),
    "stdin": ("-i --", {}, False),
    "file_and_stdin": ("-i {S} --", {}, False),
    "int": ("-int {S}", {}, False),
    "pe_pm_f": ("-ipe {S} {S} -pm f", {}, False),
    "hmm": ("-i {S} -hmm", {}, False),
    "ck": ("-i {S} -ck", {}, False),
    "proxi": ("-i {S} -proxi 0.9", {}, False),
    "ont": ("-i {S} -ont", {}, False),
    "1t1": ("-i {S} -1t1", {}, False),
    "sam": ("-i {S} -sam", {}, False),
    "xml": ("-i {S} -xml 2", {}, False),
    "boot": ("-i {S} -boot", {}, False),
    "qc": ("-i {S} -qc", {}, False),
    "no_fused": ("-i {S}", {"KMA_TPU_NO_FUSED": "1"}, False),
    "no_native": ("-i {S}", {"KMA_TPU_NO_NATIVE": "1"}, False),
    "libs_stale": ("-i {S}", {}, False),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_driver(case, sized_files, tmp_path, monkeypatch):
    """``fused_driver`` holds only where run_kma's fused gate holds on
    the command line, every input is a named FASTQ file and the native
    libraries the driver loads are current; there ``python_ops`` counts
    no SE loop, so an SE run sends nothing and a PE run only the fused
    feed's chain probes."""
    from kma_tpu_torch import native_build
    monkeypatch.setattr(native_build, "stale",
                        lambda lib: case == "libs_stale")
    flags, environ, want = FUSED_CASES[case]
    files = _idle_files(tmp_path, sized_files)
    a = cli.parse_map_args(("%s -t_db {D} -o {O}" % flags).format(
        **files).split())
    assert cli.fused_driver(a, environ) is want
    if want:
        assert cli.python_ops(a, environ, True) == (
            {"chain"} if a.pe_inputs else set())


@pytest.mark.parametrize("cli_state", ["ready", "missing", "stale",
                                       "not_executable"])
def test_idle_only_where_bin_kma_runs_the_native_cli(cli_state, tmp_path,
                                                     sized_files,
                                                     monkeypatch):
    """Without a native CLI that bin/kma would run (missing, not
    executable, or older than a native/*.cpp: bin/kma:36-44), every
    command line goes to the Python pipeline, whose chain clients ignore
    the budget: auto serves the default mode."""
    nat = tmp_path / "native"
    nat.mkdir()
    (nat / "kma_cli.cpp").write_text("")
    os.utime(nat / "kma_cli.cpp", (1000, 1000))
    binary = nat / "kma_cli"
    if cli_state != "missing":
        binary.write_text("")
        binary.chmod(0o644 if cli_state == "not_executable" else 0o755)
        os.utime(binary, (500 if cli_state == "stale" else 2000,) * 2)
    monkeypatch.setattr(cli, "NATIVE_CLI", str(binary))
    a = cli.parse_map_args(("-i {R} -t_db {D} -o {O}").format(
        **sized_files).split())
    assert cli.native_cli_ready() == (cli_state == "ready")
    on, why = cli.decide(a, lambda: True, {"KMA_TPU_DEVICE_AUTO_MB": "0"})
    assert on == (cli_state != "ready"), why


def test_an_unknown_option_stops_before_any_decision(sized_files):
    """An option neither CLI parses: map_main stops (bin/kma prints its
    usage error), so no decision is made and no daemon is started."""
    a = cli.parse_map_args(("-i {R} -t_db {D} -o {O} -nosuchflag").format(
        **sized_files).split())
    assert a.flow == "stop"
    assert cli.decide(a, lambda: True, {"KMA_TPU_DEVICE_AUTO_MB": "0"}) \
        == (False, None)


@pytest.mark.parametrize("value", ["bogus", "ON", None])
def test_bad_device_value_exits_1(value, sized_files, tmp_path, capfd,
                                  monkeypatch):
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)
    argv = ["-i", sized_files["r"], "-t_db", sized_files["D"], "-o",
            sized_files["O"], "-device"] + ([value] if value else [])
    assert torch_main(argv) == 1
    assert "# -device takes auto, on or off" in capfd.readouterr().err
    assert not os.path.exists(stub + ".args")
    if value is not None:
        assert jax_main(argv) == 1


@pytest.mark.parametrize("extra", [[], ["-device", "off"],
                                   ["-t_db", "db2"]])
def test_mh_exits_1_with_no_child(extra, sized_files, tmp_path, capfd,
                                  monkeypatch):
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)
    argv = ["-i", sized_files["r"], "-t_db", sized_files["D"], "-o",
            sized_files["O"], "-mh", "localhost:5000,2,0"] + extra
    assert torch_main(argv) == 1
    err = capfd.readouterr().err
    assert "-mh: multi-host runs need the JAX package's jax.distributed" \
        in err and "not ported" in err
    assert not os.path.exists(stub + ".args")


# -- runs: the stub child --------------------------------------------------

def _no_daemon(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a daemon was built")
    monkeypatch.setattr(launch, "start", refuse)


@pytest.mark.parametrize("thresh, device, big, route", [
    ("0", None, False, "on"),            # absent: -device on appended
    ("1", "auto", True, "on"),           # auto replaced by on
    (None, None, False, "host"),         # under the default: unchanged
    ("1", "auto", False, "host"),
    ("1", "on", True, "on"),             # on: PILEUP off, served
    ("0", "off", True, "host")])
def test_child_argv_and_pileup(thresh, device, big, route, disk_db,  # noqa: F811
                               sized_files, tmp_path, private_tmp, capfd,
                               monkeypatch):
    """Only the effective ``-device`` value changes (or ``-device on`` is
    appended); KMA_TPU_PILEUP=off reaches the child exactly under auto
    with a threshold over 0 and on every served run."""
    stub = _stub_kma(tmp_path / "kma", 5)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.delenv("KMA_TPU_PILEUP", raising=False)
    if thresh is None:
        monkeypatch.delenv("KMA_TPU_DEVICE_AUTO_MB", raising=False)
    else:
        monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", thresh)
    if route == "host":
        _no_daemon(monkeypatch)
    prefix, reads = disk_db
    argv = ["-i", reads] + ([sized_files["R"]] if big else []) \
        + (["-device", device] if device else []) \
        + ["-t_db", prefix, "-o", str(tmp_path / "o"), "-1t1", "-mrs", "0.5"]
    assert cli.run(argv, device="cpu", batch=32) == 5
    got = _read(stub, "args").split()
    if route == "on" and device is None:
        assert got == argv + ["-device", "on"]
    elif route == "on":
        assert got == [("on" if a == device else a) for a in argv]
    else:
        assert got == argv
    assert bool(_read(stub, "sock")) == (route == "on")
    auto = device in (None, "auto")
    assert _read(stub, "pileup") == ("off" if auto and thresh != "0"
                                     or route == "on" else "-")
    err = capfd.readouterr().err
    if auto:
        assert "# kma_tpu_torch: -device auto -> %s (input " % route in err
    else:
        assert "-device %s ->" % device not in err
    assert ("requests on cpu" in err) == (route == "on")
    _no_daemon_left(private_tmp)


def test_auto_without_a_card_stays_on_the_host(disk_db, sized_files,  # noqa: F811
                                               tmp_path, capfd,
                                               monkeypatch):
    """Over the threshold with no device given and no card: the child
    runs unchanged, on the host."""
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    _no_daemon(monkeypatch)
    prefix, reads = disk_db
    argv = ["-i", reads, "-t_db", prefix, "-o", str(tmp_path / "o"), "-1t1"]
    assert cli.run(argv) == 0
    assert _read(stub, "args").split() == argv
    assert "-device auto -> host (input 0.0 MB >= 0 MB; no CUDA device)" \
        in capfd.readouterr().err


@pytest.mark.parametrize("flow", ["spltdb", "spltdb_print", "mt1", "sparse",
                                  "s1", "s2"])
@pytest.mark.parametrize("device", ["on", "auto"])
def test_host_flows_start_no_daemon(flow, device, disk_db, tmp_path,  # noqa: F811
                                    capfd, monkeypatch):
    stub = _stub_kma(tmp_path / "kma", 7)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    _no_daemon(monkeypatch)
    prefix, reads = disk_db
    extra = {"spltdb": [prefix], "spltdb_print": [prefix, "-spltDB"],
             "mt1": ["-Mt1", "2"], "sparse": ["-Sparse"], "s1": ["-s1"],
             "s2": ["-s2"]}[flow]
    argv = ["-i", reads, "-t_db", prefix] + extra + [
        "-o", str(tmp_path / "o"), "-device", device]
    assert cli.run(argv, device="cpu") == 7
    assert _read(stub, "args").split() == argv
    name = {"s1": "step1", "s2": "step2"}.get(flow, flow)
    assert "-device %s -> host (the %s flow scans on the host)" % (
        device, name) in capfd.readouterr().err


@pytest.mark.parametrize("tool", cli.TOOLS)
def test_tools_go_to_bin_kma_unchanged(tool, tmp_path, monkeypatch):
    stub = _stub_kma(tmp_path / "kma", 3)
    monkeypatch.setattr(cli, "KMA", stub)
    _no_daemon(monkeypatch)
    argv = [tool, "-i", "x.fsa", "-o", "out", "-device", "on"]
    assert torch_main(argv) == 3
    assert _read(stub, "args").split() == argv
    assert _read(stub, "sock") == ""


def test_index_matches_bin_kma_index(disk_db, tmp_path):  # noqa: F811
    """``python -m kma_tpu_torch index`` writes bin/kma index's files and
    imports neither torch nor a scanner."""
    prefix, _ = disk_db
    fsa = os.path.join(os.path.dirname(prefix), "db.fsa")
    probe = ("import sys; from kma_tpu_torch.__main__ import main; "
             "rc = main(sys.argv[1:]); "
             "print(rc, 'torch' in sys.modules, "
             "'kma_tpu_torch.launch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", probe, "index", "-i", fsa,
                        "-o", str(tmp_path / "port")], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-3:] == ["0", "False", "False"], r.stdout
    r = subprocess.run([KMA, "index", "-i", fsa, "-o",
                        str(tmp_path / "kma")], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    port = sorted(p.name[len("port"):] for p in tmp_path.glob("port*"))
    assert port and port == sorted(p.name[len("kma"):]
                                   for p in tmp_path.glob("kma*"))
    for ext in port:
        assert (tmp_path / ("port" + ext)).read_bytes() \
            == (tmp_path / ("kma" + ext)).read_bytes(), ext


# -- runs: bin/kma against a CPU daemon -------------------------------------

@pytest.mark.parametrize("mode", ["1t1", "default"])
def test_auto_over_threshold_matches_device_off(mode, disk_db, native_cli,  # noqa: F811
                                                tmp_path, private_tmp, capfd,
                                                monkeypatch):
    prefix, reads = disk_db
    args = ["-i", reads, "-t_db", prefix] + (["-1t1"] if mode == "1t1"
                                             else [])
    if mode == "default":
        monkeypatch.setenv("KMA_DEV_CHAIN", "force")
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    out_dev, out_host = str(tmp_path / "dev"), str(tmp_path / "host")
    capfd.readouterr()
    assert cli.run(args + ["-o", out_dev], device="cpu", batch=32) == 0
    err = capfd.readouterr().err
    assert "# kma_tpu_torch: -device auto -> on (input " in err
    assert " >= 0 MB; cpu)" in err
    assert "# device: using devserve session" in err
    assert "devserve lost" not in err
    assert _requests(err)["dense" if mode == "1t1" else "chain"] > 0
    _no_daemon_left(private_tmp)
    r = subprocess.run([KMA] + args + ["-o", out_host, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_dev, out_host)


@pytest.mark.parametrize("flag", [[], ["-device", "auto"]])
def test_auto_under_threshold_builds_no_daemon(flag, disk_db, native_cli,  # noqa: F811
                                               tmp_path, private_tmp, capfd,
                                               monkeypatch):
    prefix, reads = disk_db
    monkeypatch.delenv("KMA_TPU_DEVICE_AUTO_MB", raising=False)
    _no_daemon(monkeypatch)
    args = ["-i", reads, "-t_db", prefix, "-1t1"]
    out_auto, out_host = str(tmp_path / "auto"), str(tmp_path / "host")
    assert cli.run(args + ["-o", out_auto] + flag, device="cpu") == 0
    err = capfd.readouterr().err
    assert "# kma_tpu_torch: -device auto -> host (input 0.0 MB < %d MB)" \
        % cli.DEFAULT_AUTO_MB in err
    assert "# device:" not in err and "requests on" not in err
    _no_daemon_left(private_tmp)
    r = subprocess.run([KMA] + args + ["-o", out_host, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_auto, out_host)


@pytest.mark.parametrize("device", ["auto", "on"])
def test_refused_db(device, cmer_db, disk_db, tmp_path, private_tmp,  # noqa: F811
                    capfd, monkeypatch):
    """A DB both scanners refuse: under auto the child runs unchanged on
    the host; under on the run exits 1 and no child runs."""
    stub = _stub_kma(tmp_path / "kma", 0)
    monkeypatch.setattr(cli, "KMA", stub)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    _, reads = disk_db
    argv = ["-i", reads, "-t_db", cmer_db, "-o", str(tmp_path / "o"),
            "-1t1", "-device", device]
    rc = cli.run(argv, device="cpu", batch=32)
    err = capfd.readouterr().err
    if device == "auto":
        assert rc == 0
        assert _read(stub, "args").split() == argv
        assert _read(stub, "sock") == ""
        assert "-device auto -> host (both device scanners refuse" in err
    else:
        assert rc == 1
        assert "no device daemon for" in err and "cmer" in err
        assert not os.path.exists(stub + ".args")
    _no_daemon_left(private_tmp)


@pytest.mark.parametrize("row", ["default", "ipe", "hmm", "ipe_ex_mode"])
def test_auto_idle_runs_stay_on_the_host(row, disk_db, pairs,  # noqa: F811
                                         native_cli, tmp_path, private_tmp,
                                         capfd, monkeypatch):
    """Over the threshold with the card's figures: the native default
    mode, -ipe and -hmm are decided "host", build no daemon and equal
    -device off, and the same runs served under -device on send the
    daemon no op; -ipe -ex_mode, which the native CLI hands to the
    Python pipeline (its fused PE path), is served and sends chain
    requests, at parity."""
    for var in ("KMA_DEV_CHAIN", "KMA_TPU_SCAN_MAX_MB", "KMA_TPU_PILEUP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KMA_TPU_DEVICE_AUTO_MB", "0")
    prefix, reads = disk_db
    inp = {"default": ["-i", reads], "hmm": ["-i", reads, "-hmm"],
           "ipe": ["-ipe", pairs[0], pairs[1]],
           "ipe_ex_mode": ["-ipe", pairs[0], pairs[1], "-ex_mode"]}[row]
    args = inp + ["-t_db", prefix]
    out_auto, out_host = str(tmp_path / "auto"), str(tmp_path / "host")
    served = row == "ipe_ex_mode"
    capfd.readouterr()
    if not served:
        with monkeypatch.context() as m:
            _no_daemon(m)
            assert cli.run(args + ["-o", out_auto], device="cpu",
                           batch=32) == 0
    else:
        assert cli.run(args + ["-o", out_auto], device="cpu",
                       batch=32) == 0
    err = capfd.readouterr().err
    if served:
        assert "# kma_tpu_torch: -device auto -> on (input " in err
        assert "devserve lost" not in err
        assert _requests(err)["chain"] >= 1
    else:
        mode = {"default": "default mode", "ipe": "-ipe",
                "hmm": "-hmm"}[row]
        assert "# kma_tpu_torch: -device auto -> host (input " in err
        assert "; %s: the card's figures keep its chain probes on the " \
            "host, KMA_TPU_SCAN_MAX_MB 0)" % mode in err
        assert "# device:" not in err and "requests on" not in err
        # what auto did before: the daemon serves the run, and gets no op
        assert cli.run(args + ["-o", str(tmp_path / "on"), "-device", "on"],
                       device="cpu", batch=32) == 0
        err = capfd.readouterr().err
        assert "# device: using devserve session" in err
        assert not any(_requests(err).values()), _requests(err)
        _same_outputs(str(tmp_path / "on"), out_auto)
    _no_daemon_left(private_tmp)
    r = subprocess.run([KMA] + args + ["-o", out_host, "-device", "off"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _same_outputs(out_auto, out_host)
