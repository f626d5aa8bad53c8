"""``kma_index.write_index``, the benchmark's frozen index writer, writes
the files ``python -m kma_tpu index`` writes, byte for byte, on a small
seeded panel and a small scheme.  The JAX package's CLI runs here as a
program, and nowhere else in the benchmark."""

import filecmp
import os
import subprocess
import sys

import pytest

from kmabench_fixtures import REPO
from kmabench import dbgen

DBS = {
    "panel": {"generator": "panel", "db_seed": 5, "templates": 400,
              "template_bp": [500, 3000], "family_size": [1, 5],
              "divergence": [0.01, 0.05]},
    "scheme": {"generator": "scheme", "db_seed": 6, "loci": 80,
               "alleles_per_locus": 12, "locus_bp": [500, 1500],
               "snps": [1, 7]},
}


@pytest.mark.parametrize("kind", sorted(DBS))
def test_index_byte_equal(tmp_path, kind):
    cfg = dict(DBS[kind], name="index_" + kind)
    db = dbgen.prepare(cfg, str(tmp_path / "cache"), log=lambda m: None)
    ref = str(tmp_path / "ref")
    subprocess.run([sys.executable, "-m", "kma_tpu", "index", "-i",
                    db["fasta"], "-o", ref], cwd=REPO, check=True,
                   capture_output=True, timeout=600,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    for ext in (".comp.b", ".length.b", ".name", ".seq.b"):
        assert filecmp.cmp(db["prefix"] + ext, ref + ext, shallow=False), ext
