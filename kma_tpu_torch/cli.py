"""``python -m kma_tpu_torch <kma args>``: the JAX package's command line
(``python -m kma_tpu``) with the card as its device.

``devserve`` is the port's daemon; the tool subcommands (``index``,
``seq2fasta``, ``db``, ``dist``, ``merge``, ``cmp``, ``shm``,
``update``, ``trim``) go to ``bin/kma`` unchanged; anything else is a
mapping run (``run`` is an alias), parsed as ``kma_tpu.cli.main`` parses
it.  Only the plain mapping flow scans on the device; the spltDB (several
``-t_db``), ``-Mt1``, ``-Sparse``, ``-s1`` and ``-s2`` flows run
``bin/kma`` unchanged with no daemon.  ``-mh`` (multi-host) is refused.

``-device`` decides the plain flow as ``kma_tpu.pipeline._device_enabled``
does, with two departures: ``off`` runs ``bin/kma`` unchanged; ``on``
serves the run from a daemon on the card (``launch.py``); ``auto``, the
default, goes as ``on`` when the ``-i``/``-ipe``/``-int`` files sum to
at least ``KMA_TPU_DEVICE_AUTO_MB`` MB (default: the card's crossover,
``envelope.py``), the served run would send the daemon an op, and a
device is present, with its ``-device`` value replaced by ``on`` (or
``-device on`` appended) and nothing else of the command line changed;
otherwise ``bin/kma`` runs unchanged on the host.  The departures, both
runs whose daemon would get no op (``idle_reason``): (1) a run the
native CLI takes itself (``native_run``, the port's copy of its
``-device on`` envelope) in the default chain mode, ``-ipe`` or
``-hmm`` sends none while its chain budget ``KMA_TPU_SCAN_MAX_MB`` is
the card's 0, unless the caller sets ``KMA_DEV_CHAIN=force`` or a
budget over 0; (2) a run the native CLI hands to the Python pipeline
sends none where ``python_ops``, the port's copy of the clients
``run_kma`` builds, finds none: PE or ``-int`` input with ``-hmm`` or an
active ``-proxi``, and SE input under ``-proxi`` or ``-ont``/``-asm``
with ``-mem_mode`` or ``KMA_TPU_NW=off`` (no NW pre-pass).  ``-1t1``
(the ``dense`` op) and every other run are served as before.  The decision is printed on
stderr before the child starts.  A served child gets the card's
figures it was not given (``envelope.child_env``) and
``KMA_TPU_PILEUP=off``, unless the caller set them.

A DB past the card's dense budget gets the pair-stream image, which
refuses the ``chain`` op; kma_tpu's Python chain clients stop a run on
that refusal.  So a run the Python pipeline takes that may send
``chain`` (``chain_refusal``) goes to the host under ``auto``, with a
second decision line, and exits 1 under ``on`` before the child
starts; a run of ``dense`` alone, or one the fused native driver maps,
is served.

This module imports no torch at import time: a tool subcommand or a
host run never touches the card.
"""

from __future__ import annotations

import functools
import gzip
import os
import re
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

from . import envelope

KMA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bin", "kma")
#: the native CLI bin/kma tries first
NATIVE_CLI = os.path.join(os.path.dirname(os.path.dirname(KMA)), "native",
                          "kma_cli")
USAGE = (
    "usage: python -m kma_tpu_torch [run] -i READS -t_db DB -o OUT "
    "[-device auto|on|off] [kma mapping options]\n"
    "       python -m kma_tpu_torch index|seq2fasta|db|dist|merge|cmp|shm|"
    "update|trim [kma tool options]\n"
    "       python -m kma_tpu_torch devserve -t_db DB [-b] [-stop] "
    "[-warm L1,L2,..] [-batch N]\n"
    "-device auto (the default) serves the run from the card when the "
    "input files sum to KMA_TPU_DEVICE_AUTO_MB (default %d) MB or more "
    "and the run would send the card work."
    % envelope.value("KMA_TPU_DEVICE_AUTO_MB"))
#: the subcommands ``kma_tpu.cli.main`` hands to its tools
TOOLS = ("index", "seq2fasta", "db", "dist", "merge", "cmp", "shm",
         "update", "trim")
DEVICE_MODES = ("auto", "on", "off")
#: -device auto's threshold when KMA_TPU_DEVICE_AUTO_MB is unset: the
#: card's crossover, measured by envelope_bench
DEFAULT_AUTO_MB = envelope.value("KMA_TPU_DEVICE_AUTO_MB")

# the mapping options of kma_tpu.cli.main.map_main by the values they take
_ONE_VALUE = frozenset((
    "-k", "-mp", "-mi", "-eq", "-5p", "-3p", "-xl", "-ml", "-mrs",
    "-mrc", "-mq", "-bcd", "-ID", "-md", "-reward", "-penalty", "-gapopen",
    "-gapextend", "-localopen", "-Npenalty", "-per", "-transition",
    "-transversion", "-proxi", "-mct", "-ts", "-e", "-p", "-t",
    "-ConClave", "-mf", "-pm", "-fpm", "-apm", "-ss"))
_NO_VALUE = frozenset((
    "-1t1", "-hmm", "-ck", "-ex_mode", "-bc90", "-bcg", "-bcNano", "-dense",
    "-ref_fsa", "-matrix", "-a", "-and", "-oa", "-cge", "-mint2", "-mint3",
    "-lc", "-ont", "-ill", "-asm", "-ca", "-ssa", "-nc", "-na", "-nf", "-ef",
    "-boot", "-mmap", "-swap", "-sasm", "-status", "-mem_mode", "-qc",
    "-deCon"))
#: a value is taken when the next argument is not a flag
_OPT_VALUE = frozenset(("-bc", "-verbose", "-shm", "-tmp"))
#: a value is taken when the next argument is digits
_DIGIT_VALUE = frozenset(("-sam", "-vcf", "-xml", "-tsv"))
#: print and return before the run starts
_INFO = frozenset(("-h", "-v", "-tsvh"))


class DeviceFlagError(ValueError):
    """``-device`` with a value other than auto, on or off."""


@dataclass
class MapArgs:
    """What ``kma_tpu.cli.main.map_main`` reads of a mapping command
    line to choose its flow and device."""
    device: str = "auto"
    #: index in argv of the effective (last) ``-device`` value
    device_at: Optional[int] = None
    out: Optional[str] = None
    dbs: List[str] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)
    pe_inputs: List[str] = field(default_factory=list)
    int_inputs: List[str] = field(default_factory=list)
    splt_db: bool = False
    mt1: int = 0
    sparse: bool = False
    step1: bool = False
    step2: bool = False
    mh: Optional[str] = None
    #: the MapConfig fields that choose run_kma's device clients, as
    #: map_main sets them (in argv order: -hmm clears one2one, a later
    #: -1t1 or preset sets it again)
    one2one: bool = False
    hmm: bool = False
    ck: bool = False
    mem_mode: bool = False
    dense: bool = False
    min_frac: float = 1.0
    sam: int = 0
    xml: int = 0
    boot: bool = False
    qc: int = 0
    pair_mode: str = "u"
    fpm: str = "u"
    #: map_main would return while parsing (-h, -v, -tsvh, a bad option or
    #: value); bin/kma then prints what it prints
    stop: bool = False
    #: the command line read
    argv: List[str] = field(default_factory=list)

    @property
    def flow(self) -> str:
        """The flow map_main runs, in its order: ``stop``, ``usage`` (too
        few arguments), ``spltdb_print``, ``spltdb``, ``mt1``, ``sparse``,
        ``step1``, ``step2``, ``multihost`` or ``map`` (run_kma, the only
        one that scans on the device)."""
        if self.stop:
            return "stop"
        if self.out is None or not self.dbs:
            return "usage"
        if self.splt_db and len(self.dbs) > 1:
            return "spltdb_print"
        if len(self.dbs) > 1:
            return "multihost" if self.mh is not None else "spltdb"
        for flow in ("mt1", "sparse", "step1", "step2"):
            if getattr(self, flow):
                return flow
        return "multihost" if self.mh is not None else "map"

    def input_files(self) -> List[str]:
        """The files run_kma sums: stdin (``--``) when none is named."""
        files = self.inputs + self.pe_inputs + self.int_inputs
        return files or ["--"]

    @functools.cached_property
    def native(self) -> Optional[NativeRun]:
        """How the native CLI reads the served child's command line
        (``native_run``): None where the Python pipeline runs it."""
        return native_run(on_argv(self.argv, self))


def parse_map_args(argv: Sequence[str]) -> MapArgs:
    """Read a mapping command line as map_main (kma_tpu/cli/main.py:238-
    653) does; DeviceFlagError for a bad ``-device`` value."""
    a = MapArgs(argv=list(argv))
    n = len(argv)

    def values(i, keep_dashdash=False):
        got = []
        while i < n and (not argv[i].startswith("-")
                         or (keep_dashdash and argv[i] == "--")):
            got.append(argv[i])
            i += 1
        return got, i

    i = 0
    while i < n:
        f = argv[i]
        if f in ("-i", "-ipe", "-int", "-t_db"):
            got, i = values(i + 1, keep_dashdash=f == "-i")
            {"-i": a.inputs, "-ipe": a.pe_inputs, "-int": a.int_inputs,
             "-t_db": a.dbs}[f].extend(got)
            if f == "-ipe" and len(a.pe_inputs) % 2:
                a.stop = True
                return a
            continue
        if f in _INFO:
            a.stop = True
            return a
        if f == "-device":
            if i + 1 >= n or argv[i + 1] not in DEVICE_MODES:
                raise DeviceFlagError(argv[i + 1] if i + 1 < n else None)
            a.device, a.device_at = argv[i + 1], i + 1
            i += 1
        elif f in ("-o", "-mh", "-Mt1") or f in _ONE_VALUE:
            if i + 1 >= n:
                a.stop = True
                return a
            i += 1
            v = argv[i]
            if f == "-o":
                a.out = v
            elif f == "-mh":
                a.mh = v
            elif f in ("-Mt1", "-proxi"):
                try:
                    x = int(v) if f == "-Mt1" else float(v)
                except ValueError:
                    a.stop = True
                    return a
                if f == "-Mt1":
                    a.mt1 = x
                elif not -1 <= x <= 1:
                    a.stop = True
                    return a
                else:
                    a.min_frac = x
            elif f in ("-pm", "-fpm", "-apm"):
                if f != "-fpm":
                    a.pair_mode = v[:1]
                if f != "-pm":
                    a.fpm = v[:1]
        elif f == "-spltDB":
            a.splt_db = True
        elif f == "-Sparse":
            a.sparse = True
        elif f == "-s1":
            a.step1 = True
        elif f == "-s2":
            a.step2 = True
        elif f in _OPT_VALUE:
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
        elif f in _DIGIT_VALUE:
            level = 1
            if i + 1 < n and argv[i + 1].isdigit():
                i += 1
                level = int(argv[i])
            if f in ("-sam", "-xml"):
                setattr(a, f[1:], level)
        elif f in _NO_VALUE:
            _set_mode(a, f)
        else:
            a.stop = True
            return a
        i += 1
    return a


def _set_mode(a: MapArgs, f: str) -> None:
    """What a flag of no value sets of ``a``'s device fields
    (kma_tpu/cli/main.py:275-636)."""
    if f in _ONE2ONE:
        a.one2one = True
    if f == "-hmm":
        a.hmm, a.one2one = True, False
    if f in ("-mint2", "-mint3"):
        a.mem_mode = a.dense = True
    if f in _PRESET_PROXI:
        a.min_frac = _PRESET_PROXI[f]
    if f in ("-ck", "-mem_mode", "-dense", "-boot"):
        setattr(a, f[1:], True)
    if f == "-qc":
        a.qc += 1


def auto_threshold_mb(environ: Mapping[str, str] = os.environ) -> int:
    """``KMA_TPU_DEVICE_AUTO_MB`` as an int; DEFAULT_AUTO_MB when unset
    or not one."""
    try:
        return int(environ.get("KMA_TPU_DEVICE_AUTO_MB",
                               str(DEFAULT_AUTO_MB)))
    except ValueError:
        return DEFAULT_AUTO_MB


def input_bytes(files: Sequence[str]) -> int:
    """The summed sizes of ``files``; one that cannot be read counts 0."""
    total = 0
    for f in files:
        try:
            total += os.path.getsize(f)
        except OSError:
            pass
    return total


# -- the native CLI's -device on envelope ------------------------------------
# A conservative copy of what native/kma_cli.cpp:560-893 takes itself: a
# command line it is not sure of counts as handed to the Python pipeline,
# which is served, so an error here can only start a daemon that was not
# needed.

#: options the native CLI parses that take one value
_NATIVE_ONE_VALUE = frozenset((
    "-t_db", "-o", "-t", "-ID", "-md", "-bcd", "-mrs", "-mrc", "-ml", "-mp",
    "-e", "-p", "-mq", "-eq", "-mi", "-xl", "-5p", "-3p", "-reward",
    "-penalty", "-gapopen", "-gapextend", "-localopen", "-Npenalty", "-per",
    "-transition", "-transversion", "-mf", "-mct", "-ts"))
#: options it parses whose value must be one of these
_NATIVE_CHOICE = {"-apm": ("u", "p", "f"), "-pm": ("u", "p", "f"),
                  "-fpm": ("u", "p", "f"), "-device": ("on", "off"),
                  "-ConClave": ("1", "2")}
#: options it parses that take no value
_NATIVE_NO_VALUE = frozenset((
    "-1t1", "-hmm", "-mem_mode", "-bcNano", "-bc90", "-bcg", "-lc", "-ca",
    "-dense", "-cge", "-ont", "-ill", "-asm", "-mint2", "-mint3", "-matrix",
    "-ef", "-nc", "-na", "-nf"))
#: a value is taken when the next argument does not start with "-"
_NATIVE_OPT_VALUE = frozenset(("-bc", "-ref_fsa"))
#: a value is taken when the next argument starts with a digit
_NATIVE_DIGIT_VALUE = frozenset(("-xml", "-tsv", "-sam", "-vcf"))
#: options that make the run -1t1's, which uses the dense op: -1t1 and the
#: presets that set it (kma_cli.cpp:760-821)
_ONE2ONE = frozenset(("-1t1", "-ill", "-mint2", "-mint3"))
#: the -proxi value of the presets that set one (kma_cli.cpp:745-784)
_PRESET_PROXI = {"-ont": -0.9, "-ill": -0.98, "-asm": -0.9}


@dataclass
class NativeRun:
    """A served command line the native CLI runs itself."""
    #: an option that sets -1t1 is present (the dense op)
    one2one: bool
    #: "-ipe" or "-int" (paired input; the first named), or None
    pe: Optional[str]
    hmm: bool

    @property
    def mode(self) -> str:
        return " ".join(m for m in (self.pe, "-hmm" if self.hmm else None)
                        if m) or "default mode"


def _first_byte(path: str) -> bytes:
    """The first byte of ``path`` as gzopen reads it; b"" when it cannot
    be read."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
        if head == b"\x1f\x8b":
            with gzip.open(path, "rb") as g:
                head = g.read(1)
    except (OSError, EOFError, zlib.error):
        return b""
    return head[:1]


def _seq_file(path: str) -> bool:
    """The native CLI's ``seq_format`` (kma_cli.cpp:279-286) is not 0:
    the first byte as gzopen reads it is '@' or '>'."""
    return _first_byte(path) in (b"@", b">")


def native_cli_ready() -> bool:
    """bin/kma runs the native CLI (bin/kma:36-44): it is executable and
    no ``native/*.cpp`` is newer."""
    if not os.access(NATIVE_CLI, os.X_OK):
        return False
    d = os.path.dirname(NATIVE_CLI)
    built = os.path.getmtime(NATIVE_CLI)
    return not any(os.path.getmtime(os.path.join(d, f)) > built
                   for f in os.listdir(d) if f.endswith(".cpp"))


def native_run(argv: Sequence[str]) -> Optional[NativeRun]:
    """How the native CLI reads ``argv``, the command line of a served
    child (``-device on``): None where it hands the run to the Python
    pipeline (``return FALLBACK``), where bin/kma would not run it, or
    where this copy cannot tell."""
    if not native_cli_ready():
        return None
    n = len(argv)
    se: List[str] = []
    pe_files: List[str] = []
    pe = None
    hmm = one2one = False
    min_frac = 1.0
    i = 0
    while i < n:
        f = argv[i]
        if f in ("-i", "-ipe", "-int"):
            got = []
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                got.append(argv[i])
            if f == "-i":
                se += got
            elif not got or (f == "-ipe" and len(got) % 2):
                return None
            else:
                pe = pe or f
                pe_files += got
        elif f in _NATIVE_ONE_VALUE or f in _NATIVE_CHOICE or f == "-proxi":
            if i + 1 >= n:
                return None
            i += 1
            v = argv[i]
            if f in _NATIVE_CHOICE and v not in _NATIVE_CHOICE[f]:
                return None
            if f == "-proxi":
                try:
                    min_frac = float(v)
                except ValueError:
                    return None
                if not -1 <= min_frac <= 1:
                    return None
        elif f in _NATIVE_NO_VALUE:
            hmm = hmm or f == "-hmm"
            one2one = one2one or f in _ONE2ONE
            min_frac = _PRESET_PROXI.get(f, min_frac)
        elif f in _NATIVE_OPT_VALUE:
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
        elif f in _NATIVE_DIGIT_VALUE:
            if i + 1 < n and argv[i + 1][:1].isdigit():
                i += 1
        else:
            return None
        i += 1
    if not se and pe is None:
        return None
    if not all(map(_seq_file, se + pe_files)):
        return None
    # PE with -hmm and an active or -1 -proxi go to the Python pipeline
    # under -device on (kma_cli.cpp:876-885)
    if (hmm and pe) or min_frac != 1.0:
        return None
    return NativeRun(one2one, pe, hmm)


# -- the Python pipeline's device envelope ----------------------------------
# A copy of the daemon clients kma_tpu.pipeline.run_kma builds under
# -device on (pipeline.py:1525-1900, :2444-2457), for the command lines the
# native CLI hands over.  What the copy cannot tell counts as "may send":
# the DB is taken as plain (not sparse, k <= 16, no flag bits), the native
# aligner as built, and the fused driver as maybe not built unless the
# caller found it sure (``fused_driver``), so an error here can only start
# a daemon that was not needed.

#: the native libraries the fused driver loads (kma_tpu/io/native_io.py,
#: kma_tpu/run_native.py)
_FUSED_LIBS = ("libkma_io.so", "libkma_run.so")


def _fused_gate(a: MapArgs, environ: Mapping[str, str]) -> bool:
    """The command line passes the fused driver's gate
    (pipeline.py:1591-1601)."""
    proxi, _ = _proxi(a)
    se = [f for f in a.inputs if f != "--"]
    return (not a.int_inputs
            and (not a.pe_inputs or (a.pair_mode in ("u", "p")
                                     and a.fpm in ("u", "p")))
            and bool(se or a.pe_inputs) and not a.ck and not a.hmm
            and not proxi and not a.sam and not a.xml and not a.boot
            and not a.qc and not _dense_stream(a)
            and not environ.get("KMA_TPU_NO_FUSED"))


def _proxi(a: MapArgs) -> Tuple[bool, bool]:
    """(an active -proxi, a soft one) as the scanners see it: |minFrac|,
    soft only in mem_mode (pipeline.py:1274-1281)."""
    frac = -a.min_frac if not a.mem_mode and a.min_frac < 0 else a.min_frac
    return frac < 1.0, frac < 0


def _dense_stream(a: MapArgs) -> bool:
    """run_kma builds the dense stream (pipeline.py:1535-1545): -1t1,
    not -ck, no soft -proxi."""
    return a.one2one and not a.ck and not _proxi(a)[1]


def fused_driver(a: MapArgs, environ: Mapping[str, str] = os.environ
                 ) -> bool:
    """``run_kma`` surely maps ``a`` with the fused native driver
    (pipeline.py:1591-1609), so its SE loop never runs: the gate holds,
    no ``-1t1``, every input is a named FASTQ file (``detect_format``),
    and the native libraries the driver loads are built and current
    (``native_build.stale``)."""
    from . import native_build
    if a.one2one or "--" in a.inputs or environ.get("KMA_TPU_NO_NATIVE") \
            or not _fused_gate(a, environ):
        return False
    if any(native_build.stale(lib) for lib in native_build.LIBS
           if lib.name in _FUSED_LIBS):
        return False
    return all(_first_byte(f) == b"@" for f in a.inputs + a.pe_inputs)


def python_ops(a: MapArgs, environ: Mapping[str, str] = os.environ,
               fused: bool = False) -> frozenset:
    """The daemon ops ``kma_tpu.pipeline.run_kma`` may send when it runs
    ``a`` under -device on (the native CLI hands it over: ``native_run``
    is None), ``environ`` being the child's environment: ``dense``,
    ``chain``, ``nw_qext``, ``pileup``.  ``fused``: the caller found
    that the fused driver maps the run (``fused_driver``); otherwise the
    SE loop counts as taken too.  ``nw_qext`` depends on the reads (a
    window over 1 << 15 cells), so it is counted wherever the SE loop's
    batched step 3 runs."""
    proxi, _ = _proxi(a)
    paired = bool(a.pe_inputs or a.int_inputs)
    dense = _dense_stream(a)
    ops = set()
    # the fused driver's PE feed probes through the chain op (:1667-1672,
    # pe_device.py:87-99); its SE feed sends nothing
    if a.pe_inputs and _fused_gate(a, environ):
        ops.add("chain")
    # the unfused SE loop (:1675); the unfused PE loop sends nothing
    se = (any(f != "--" for f in a.inputs) or not paired) and not fused
    if se:
        if dense:
            ops.add("dense")
        elif a.hmm or (a.ck and a.one2one):
            ops.add("chain")            # DeviceHmmStream (:1886-1895)
        elif not a.one2one and not proxi:
            ops.add("chain")            # DeviceChainStream (:1841-1850)
        # the NW pre-pass (:1559, :1566-1570, used at :1729-1733, the SE
        # loop's step 3 only; nw_device.py:216-232)
        if not a.mem_mode and environ.get("KMA_TPU_NW", "auto") != "off":
            ops.add("nw_qext")
    # the pileup client (:2444-2457); the launcher gives every served run
    # KMA_TPU_PILEUP=off unless the caller set it
    if a.dense and environ.get("KMA_TPU_PILEUP", "off") != "off":
        ops.add("pileup")
    return frozenset(ops)


def _options(a: MapArgs) -> str:
    """``a``'s command line but its files, DB, output and ``-device``:
    what the decision line names."""
    skip = set(a.input_files()) | set(a.dbs) | {
        a.out, "-i", "-t_db", "-o", "-device", "--"}
    return " ".join(f for j, f in enumerate(a.argv) if f not in skip
                    and a.argv[j - 1:j] != ["-device"]) or "default mode"


def _atoll(s: str) -> int:
    """C's atoll: the leading integer of ``s``, 0 when there is none."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def idle_reason(a: MapArgs, environ: Mapping[str, str] = os.environ
                ) -> Optional[str]:
    """Why a served run of ``a`` would send the daemon no op, or None
    when it may send one: the native CLI runs it itself, not as -1t1,
    and its chain budget (``KMA_TPU_SCAN_MAX_MB``, the card's 0 unless
    the caller set it) keeps every chain probe on the host
    (kma_cli.cpp:1010-1023 SE, :1305-1326 PE) unless
    ``KMA_DEV_CHAIN=force``; or the native CLI hands it to the Python
    pipeline, and ``python_ops`` is empty."""
    nr = a.native
    if nr is None:
        if python_ops(a, environ):
            return None
        return "%s: the Python pipeline sends the card no op" % _options(a)
    if nr.one2one or environ.get("KMA_DEV_CHAIN") == "force":
        return None
    name = "KMA_TPU_SCAN_MAX_MB"
    if name in environ:
        if _atoll(environ[name]) > 0:
            return None
        return "%s: the caller's %s=%s keeps its chain probes on the host" \
            % (nr.mode, name, environ[name])
    if envelope.value(name) > 0:
        return None
    return "%s: the card's figures keep its chain probes on the host, " \
        "%s %d" % (nr.mode, name, envelope.value(name))


def chain_refusal(a: MapArgs, environ: Mapping[str, str] = os.environ
                  ) -> Optional[str]:
    """Why a daemon on the pair-stream image (a DB past the card's dense
    budget) cannot serve ``a``, or None when it can: the run goes to the
    Python pipeline and may send ``chain``, which that image refuses
    (devserve.ChainRefused), and kma_tpu's chain clients stop the run on
    the refusal (ROADMAP.md, Queue 3).  The native CLI's chain probes
    take the host at parity instead, and a run of ``dense`` alone
    (-1t1) or one the fused driver maps (``fused_driver``) is served."""
    if a.native is not None or "chain" not in python_ops(
            a, environ, fused_driver(a, environ)):
        return None
    return "%s on the pair-stream image of %s: the image refuses the " \
        "chain op, and the Python pipeline's chain clients stop the run " \
        "on that refusal (a fault of kma_tpu, ROADMAP.md Queue 3)" % (
            _options(a), a.dbs[0])


def decide(a: MapArgs, present: Callable[[], bool],
           environ: Mapping[str, str] = os.environ
           ) -> Tuple[bool, Optional[str]]:
    """(whether a daemon serves the run, the reason the decision line
    gives or None).  The plain flow under ``auto`` is decided as
    ``_device_enabled`` (kma_tpu/pipeline.py:1170-1194) decides it,
    except that a run that would send the daemon no op stays on the host
    (``idle_reason``); ``present()`` is asked only when the input reaches
    the threshold and the run would send one."""
    flow = a.flow
    if a.device == "off" or flow in ("stop", "usage", "multihost"):
        return False, None
    if flow != "map":
        return False, "the %s flow scans on the host" % flow
    if a.device == "on":
        return True, None
    thresh = auto_threshold_mb(environ)
    nbytes = input_bytes(a.input_files())
    size = "input {:,.1f} MB".format(nbytes / 2 ** 20)
    if nbytes < thresh * (1 << 20):
        return False, "%s < %d MB" % (size, thresh)
    idle = idle_reason(a, environ)
    if idle is not None:
        return False, "%s >= %d MB; %s" % (size, thresh, idle)
    if not present():
        return False, "%s >= %d MB; no CUDA device" % (size, thresh)
    return True, "%s >= %d MB" % (size, thresh)


def _present(device, devices) -> bool:
    if device is not None or devices:
        return True
    import torch
    return torch.cuda.is_available()


def _where(device, devices) -> str:
    if device is not None:
        return str(device)
    return ", ".join(map(str, devices)) if devices else "cuda:0"


def on_argv(argv: Sequence[str], a: MapArgs) -> List[str]:
    """``argv`` with its effective ``-device`` value made ``on`` (or
    ``-device on`` appended); every other argument as it was."""
    out = list(argv)
    if a.device_at is None:
        return out + ["-device", "on"]
    out[a.device_at] = "on"
    return out


def say(msg: str) -> None:
    print("# kma_tpu_torch: " + msg, file=sys.stderr)


def child(argv: Sequence[str],
          env: Optional[Mapping[str, str]] = None) -> int:
    """``bin/kma <argv>``; its exit code."""
    return subprocess.run([KMA] + list(argv), env=env).returncode


def run(argv: List[str], device=None, devices=None,
        batch: Optional[int] = None) -> int:
    """One mapping run: ``bin/kma <argv>`` as it is, or served by a
    daemon on ``device`` (None: the CUDA card) or sharded over
    ``devices``, as ``-device`` decides.  Returns the exit code."""
    t0 = time.perf_counter()
    try:
        a = parse_map_args(argv)
    except DeviceFlagError:
        print("# -device takes auto, on or off", file=sys.stderr)
        return 1
    flow = a.flow
    if flow == "usage":
        print(USAGE, file=sys.stderr)
        return 1
    if flow == "multihost":
        say("-mh: multi-host runs need the JAX package's jax.distributed "
            "and are not ported (ROADMAP.md)")
        return 1
    env = dict(os.environ)
    if a.device == "auto" and auto_threshold_mb(env) > 0:
        # kma_tpu decides -dense's count scatter with 0 input bytes
        # (pipeline.py:2444): under auto it stays on the host
        env["KMA_TPU_PILEUP"] = "off"
    on, why = decide(a, lambda: _present(device, devices), env)
    if on and "KMA_TPU_PILEUP" not in env:
        # a served -dense run would take the daemon's pileup op through
        # kma_tpu's client, which imports jax (pipeline.py:2449): the
        # count scatter stays on the host, as under auto
        env["KMA_TPU_PILEUP"] = "off"
        if "-dense" in argv:
            say("KMA_TPU_PILEUP=off: kma_tpu's pileup client imports jax "
                "(pipeline.py:2449), so -dense's count scatter stays on "
                "the host")
    if why is not None:
        say("-device %s -> %s (%s)" % (
            a.device, "on" if on else "host",
            why + "; " + _where(device, devices) if on else why))
    if not on:
        return child(argv, env)
    from . import launch
    db = a.dbs[0]
    try:
        # torch's import (by the decision or by launch) and the decision
        srv = launch.start(db, device, devices, batch,
                           time.perf_counter() - t0)
    except Exception as e:  # no card, a CUDA error, a DB refused
        if a.device == "auto" and isinstance(e, NotImplementedError):
            # both scanners refuse the DB: kma_tpu's in-process path
            # falls back to the host too (pipeline.py:1552)
            say("-device auto -> host (both device scanners refuse %s: %s)"
                % (db, e))
            return child(argv, env)
        print("# kma_tpu_torch run: no device daemon for %s: %r" % (db, e),
              file=sys.stderr)
        return 1
    refused = chain_refusal(a, env) if srv.scanner_kind == "pair_stream" \
        else None
    if refused is None:
        return launch.serve_run(srv, db, [KMA] + on_argv(argv, a), env)
    del srv
    launch.free_cards()
    if a.device == "auto":
        say("-device auto -> host (%s; the host runs it at parity)" % refused)
        return child(argv, env)
    print("# kma_tpu_torch run: -device on cannot serve this run: %s; run "
          "it with -device off or auto" % refused, file=sys.stderr)
    return 1


def main(argv: List[str]) -> int:
    if argv and argv[0] == "devserve":
        from .devserve import devserve_main
        return devserve_main(argv[1:])
    if argv and argv[0] == "--help":
        print(USAGE, file=sys.stderr)
        return 0
    if argv and argv[0] in TOOLS:
        return child(argv)
    return run(argv[1:] if argv and argv[0] == "run" else argv)
