"""The readers of the daemon's span record on the tiny cells: under
``--trace 1`` each reads a number from a CPU daemon's spans, and none
reads one once the ring has dropped spans of the window."""

import time

import pytest

from kmabench_fixtures import tiny_root  # noqa: F401
from kmabench import harness

SEED = "3000000019"
#: each reader and the tiny cell it is read in
READERS = [("upload_ms.requests", "tiny.wire"),
           ("op_lock_wait_ms.requests", "tiny.wire"),
           ("resolve_host_ms.requests", "tiny.wire"),
           ("idle_under_lock_share.requests", "tiny.wire"),
           ("upload_ms.samples", "tiny.samples"),
           ("resolve_host_ms.samples", "tiny.samples"),
           ("idle_no_request_share.samples", "tiny.samples")]


def _flood():
    """The ring past its capacity: every span it held dropped."""
    from kma_tpu_torch import tracing
    rec = tracing.latest()
    n0, t = rec.n, time.perf_counter()
    for i in range(rec.capacity):
        rec.request(1 << 20, i).add(tracing.RECV, t, t)
    assert rec.dropped == n0 > 0


@pytest.fixture(scope="module")
def traced(tiny_root):  # noqa: F811
    """{metric: (its reading of a traced run of its cell, its reading of
    that run once the ring dropped the window's spans)}, each read while
    the run's daemon is the newest (the one ``tracing.latest()`` gives)."""
    out = {}
    real = harness.reader
    saved = harness.TRACE_WARMUP_S
    harness.TRACE_WARMUP_S = 0.5
    try:
        # the samples window long enough that the CPU daemon answers
        # requests before the profiler starts (the part its readers read)
        for cell, seconds in (("tiny.wire", "2"), ("tiny.samples", "12")):
            seen = []

            class Keep:
                def __init__(self, mod):
                    self.mod = mod

                def read(self, res):
                    seen.append(res)
                    return self.mod.read(res)

            harness.reader = lambda root, name: Keep(real(root, name))
            line = harness.run(["--workload", cell, "--seed", SEED,
                                "--seconds", seconds, "--trace", "1"],
                               root=tiny_root, device="cpu", batch=64)
            assert line["correct"] is True, line["checks"]
            names = [n for n, c in READERS if c == cell]
            for n in names:
                assert n in line["metrics"]
            got = {n: real(tiny_root, n).read(seen[0]) for n in names}
            _flood()
            for n in names:
                out[n] = (got[n], real(tiny_root, n).read(seen[0]))
    finally:
        harness.reader = real
        harness.TRACE_WARMUP_S = saved
    return out


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_reader_reads_the_spans(traced, name):
    v = traced[name][0]
    assert isinstance(v, float) and v >= 0
    if name.startswith("idle_"):
        assert v <= 100
    else:
        assert v > 0


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_reader_gives_none_once_spans_dropped(traced, name):
    assert traced[name][1] is None
