"""``correct`` comes out false when the timed path is broken underneath:
each fault a cell can have (an answer altered where the dense op
produces it, half of each request left out) and the control (each read's
ties cut to one template), on the tiny cells with a CPU daemon; and the
control at each cell's own size on the card, on three seeds."""

import pytest

from kmabench_fixtures import TINY_CELLS, tiny_root  # noqa: F401
from kmabench import faults, harness


@pytest.mark.parametrize("cell", [c for c, _, _ in TINY_CELLS])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS) + ["control"])
def test_fault_is_incorrect(tiny_root, cell, fault):
    f = faults.CONTROL if fault == "control" else faults.FAULTS[fault]
    out = harness.run(["--workload", cell, "--seed", "3000000029",
                       "--seconds", "2"], root=tiny_root, device="cpu",
                      batch=64, fault=f)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cgmlst.dense_wire",
                                  "resfinder.isolate_samples"])
@pytest.mark.parametrize("seed", [4000000001, 4000000002, 4000000003])
def test_control_on_the_card(cell, seed):
    """The control at the cell's own size (a 10 s window); prints the
    numbers it reads, the upper readings of PERF.md."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(["--workload", cell, "--seed", str(seed),
                       "--seconds", "10"], fault=faults.CONTROL)
    print("control %s seed %d: %s" % (cell, seed, out["checks"]))
    assert out["correct"] is False, out["checks"]
