"""Share (%) of the native CLI's wall in step 3, summed over the
window's samples: the ``build`` and ``score`` seconds of every ``# krun
prof:`` line (the alignment of the reads the dense op mapped) over the
``total`` of each run's ``# cli prof: output ..., total T s`` line,
both printed under ``KMA_RUN_PROF=1``.  (The ``scan`` beside them reads
~0 on the served ``-1t1`` path: the dense op does that scan.)"""

import re

TOTAL = re.compile(r"# cli prof: .*total ([0-9.]+) s")


def read(res):
    step3 = total = 0.0
    for run in getattr(res.load, "runs", []):
        for line in run["prof"]:
            if line.startswith("# krun prof:"):
                f = line.split(":", 1)[1].split()
                kv = dict(zip(f[::2], f[1::2]))
                step3 += float(kv["build"]) + float(kv["score"])
            m = TOTAL.search(line)
            if m:
                total += float(m.group(1))
    return 100.0 * step3 / total if total > 0 else None
