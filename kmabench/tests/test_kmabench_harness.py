"""The harness rehearsed on the CPU: each load runs a tiny cell end to
end against a CPU daemon (the wire load's pipelined clients, the samples
load's native CLI), and its result is well formed and correct; the
cells, configurations, mixes and a metric the tests add as new files
are found by name; a run with no card, an unknown cell or no port beside
it gives no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from kmabench_fixtures import REPO, TINY_CELLS, tiny_root  # noqa: F401
from kmabench import harness

SEED = "3000000017"


def tiny_run(root, cell, trace=0, fault=None, seconds="2"):
    return harness.run(["--workload", cell, "--seed", SEED, "--seconds",
                        seconds, "--trace", str(trace)], root=root,
                       device="cpu", batch=64, fault=fault)


@pytest.mark.parametrize("cell", [c for c, _, _ in TINY_CELLS])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell(tiny_root, cell, trace, monkeypatch):
    # a traced samples window: long enough that the CPU daemon answers
    # requests before the profiler starts (the dense ms it reads)
    monkeypatch.setattr(harness, "TRACE_WARMUP_S", 0.5)
    out = tiny_run(tiny_root, cell, trace,
                   seconds="12" if trace and cell == "tiny.samples" else "2")
    line = json.loads(json.dumps(out))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in harness.cell_metrics(bench, cell, trace)}
    got = set(line["metrics"])
    if trace:
        # the CPU daemon's operations run on its own threads, which the
        # profiler does not follow: only a card's trace reads them
        assert dev["window_s"] > 0 and dev["busy_s"] >= 0
        # the samples mix traces its window's last trace_seconds alone
        if cell == "tiny.samples":
            assert abs(dev["window_s"] - 1.0) < 1e-6
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the metric added as a file of its own is read by name; the
        # kernel's roofline has no CUDA kernel to read on the CPU
        assert "tiny_answered" in got
        assert got <= want and want - got <= {
            "run_score_roofline.requests"}
    else:
        assert got == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_unknown_cell(tiny_root):
    with pytest.raises(harness.Fail, match="unknown workload"):
        tiny_run(tiny_root, "tiny.nothing")


def run_py(root, *args):
    return subprocess.run([sys.executable,
                           os.path.join(root, "kmabench", "run.py"),
                           "--workload", "cgmlst.dense_wire", "--seed",
                           SEED, "--seconds", "1", "--trace", "0", *args],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    """On a machine without a CUDA card the command exits 3 and prints
    nothing on stdout (decided in the test: a card makes it moot)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = run_py(REPO)
    assert r.returncode == 3 and r.stdout == "", r.stderr[-2000:]
    assert "no CUDA card" in r.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's
    files gives no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "kmabench"), tmp_path / "kmabench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = run_py(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""


def test_no_forbidden_module_loaded(tiny_root):
    """A run loads no module named jax or kma_tpu (whole top-level
    names: the port's kma_tpu_torch is not one)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r); "
         "from kmabench import harness; "
         "harness.run(['--workload', 'tiny.wire', '--seed', '5', "
         "'--seconds', '1'], root=%r, device='cpu', batch=64); "
         "print(harness.forbidden_modules(), "
         "'kma_tpu_torch' in sys.modules)" % (REPO, tiny_root)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "[] True"
