"""Faults planted under the timed path, and the control, for the tests
that see ``correct`` come out false (``kmabench/tests/
test_kmabench_faults.py``); the benchmark's runs use none of them.

Each is a function of the daemon, given after its start: it wraps the
``scan_resolve`` of the daemon's scanners, where the dense op's answers
are produced, so every request's answers pass through it.

- ``answer_altered``: every mapped read's score one higher;
- ``half_left_out``: the second half of every request's reads answered
  as unmapped;
- ``ties_cut`` (the control): each read's equal-best templates cut to
  the first, the answer a one-template shortcut would give, which breaks
  the configurations' guarantee that a read's answer is KMA's
  save_kmers answer.
"""

from __future__ import annotations

import numpy as np


def _wrap(srv, change) -> None:
    for sc in srv.scanners.values():
        resolve = sc.scan_resolve

        def scan_resolve(h, _resolve=resolve):
            scores, modes, tids, over = _resolve(h)
            change(scores, modes, tids)
            return scores, modes, tids, over

        sc.scan_resolve = scan_resolve


def answer_altered(srv) -> None:
    def change(scores, modes, tids):
        scores[np.asarray(modes) != 0] += 1
    _wrap(srv, change)


def half_left_out(srv) -> None:
    def change(scores, modes, tids):
        h = len(scores) // 2
        scores[h:] = 0
        modes[h:] = 0
        for i in range(h, len(tids)):
            tids[i] = None
    _wrap(srv, change)


def ties_cut(srv) -> None:
    def change(scores, modes, tids):
        for i, t in enumerate(tids):
            if t is not None and len(t) > 1:
                tids[i] = t[:1]
    _wrap(srv, change)


FAULTS = {"answer_altered": answer_altered, "half_left_out": half_left_out}
CONTROL = ties_cut
