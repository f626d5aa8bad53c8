"""What the benchmark's own tests share (``python -m pytest
kmabench/tests`` from the root of the repository; ``-m cuda`` selects
the tests that need a card, which skip without one): the tiny cells and
their checkout."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: a tiny configuration of each generator, and a mix of each load
#: (smaller DBs than these meet the dense image's failed cuckoo build and
#: are served by the pair-stream scanner)
TINY_CONFIGS = {
    "tiny_scheme": {
        "source": "the tests' tiny scheme", "generator": "scheme",
        "db_seed": 11, "loci": 60, "alleles_per_locus": 10,
        "locus_bp": [500, 1500], "snps": [1, 7], "kmersize": 16,
        "kma_flags": ["-1t1", "-device", "on"],
        "penalties": {"M": 1, "MM": -2, "U": -1, "W1": -3}},
    "tiny_panel": {
        "source": "the tests' tiny panel", "generator": "panel",
        "db_seed": 12, "templates": 300, "template_bp": [500, 3000],
        "family_size": [1, 5], "divergence": [0.01, 0.05], "kmersize": 16,
        "kma_flags": ["-1t1", "-device", "on"],
        "penalties": {"M": 1, "MM": -2, "U": -1, "W1": -3}},
}
TINY_MIXES = {
    "tiny_wire": {
        "load": "wire", "clients": 2, "reads_per_request": 256,
        "depth": 3, "pool_requests": 3, "check_reads_per_request": 8,
        "isolate": {"genes": "one_per_group", "background_bp": 0,
                    "read_bp": 150, "substitution_rate": 0.01,
                    "rc_share": 0.5}},
    "tiny_samples": {
        "load": "samples", "clients": 2, "reads_per_sample": 3000,
        "pool_samples": 3, "check_reads_per_request": 64,
        "trace_seconds": 1,
        "isolate": {"genes": 2, "background_bp": 20000, "read_bp": 100,
                    "substitution_rate": 0.01, "rc_share": 0.5}},
}
TINY_CELLS = [("tiny.wire", "tiny_scheme", "tiny_wire"),
              ("tiny.samples", "tiny_panel", "tiny_samples")]
#: a per-layer metric the tests add as a file of its own
TINY_METRIC = '''"""Units (requests or sample runs) the load finished in the
window (a test's metric)."""


def read(res):
    return float(res.load.attempted) or None
'''


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout whose benchmark holds the tiny cells: the repository's
    ``kmabench`` copied, the port and the native sources linked, and the
    tiny configurations, mixes, metric and cells added as new files and
    entries (no file of the copy edited)."""
    root = str(tmp_path_factory.mktemp("root"))
    shutil.copytree(os.path.join(REPO, "kmabench"),
                    os.path.join(root, "kmabench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    for d in ("kma_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, d), os.path.join(root, d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    kb = os.path.join(root, "kmabench")
    for name, cfg in TINY_CONFIGS.items():
        path = os.path.join(kb, "configs", name + ".json")
        assert not os.path.exists(path)
        with open(path, "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": "kmabench/configs/%s.json" % name,
                                 "reduced": [], "why": "tests"})
    for name, mix in TINY_MIXES.items():
        path = os.path.join(kb, "traffic", name + ".json")
        assert not os.path.exists(path)
        with open(path, "w") as f:
            json.dump(mix, f)
    for cell, cfg, mix in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [c for c, _, x in TINY_CELLS
                               if (m["name"] == "reads_per_s")
                               == (x == "tiny_samples")]
    for m in bench["per_layer"]:
        m["workloads"] += [c for c, _, x in TINY_CELLS
                           if m["name"].startswith("setup.")
                           or m["name"].endswith(
                               ".samples" if x == "tiny_samples"
                               else ".requests")]
    path = os.path.join(kb, "metrics", "tiny_answered.py")
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write(TINY_METRIC)
    bench["per_layer"].append({
        "name": "tiny_answered", "unit": "units", "better": "higher",
        "source": "program_counter", "layer": "daemon, devserve.py",
        "moves": "setup_s", "workloads": [c for c, _, _ in TINY_CELLS]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
