"""What the loads share: the DB's arrays, the penalties, and the
comparison of recorded dense answers with the reference."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np


def db_arrays(db: Dict):
    return (np.load(db["codes"]), np.load(db["offsets"]),
            np.load(db["groups"]))


def penalties(cfg: Dict) -> SimpleNamespace:
    """The scan's rewards (M, MM, U, W1) as the dense op's meta takes
    them: KMA's defaults, stated by the configuration."""
    p = cfg["penalties"]
    return SimpleNamespace(M=p["M"], MM=p["MM"], U=p["U"], W1=p["W1"])


def compare_dense(kmap, answers: List, pen) -> Dict[str, int]:
    """Hold recorded answers [(codes, length, (score, mode, over,
    tids))] against the reference: {"checked": n, "wrong": answers that
    differ in score, mode or template ids, or come back flagged for the
    host (every read of these cells fits the card's caps)}."""
    from .. import reference
    if not answers:
        return {"checked": 0, "wrong": 0}
    L = max(len(c) for c, _, _ in answers)
    codes = np.full((len(answers), L), 4, np.uint8)
    for i, (c, n, _) in enumerate(answers):
        codes[i, :n] = c[:n]
    lens = np.array([n for _, n, _ in answers], np.int64)
    ref = reference.scan(kmap, codes, lens,
                         (pen.M, pen.MM, pen.U, pen.W1))
    wrong = 0
    for (_, _, (score, mode, over, tids)), want in zip(answers, ref):
        if over or (score, mode, tuple(tids)) != want:
            wrong += 1
    return {"checked": len(answers), "wrong": wrong}


def in_flight(units: List[Dict], t: float, clients: int, what: str) -> str:
    """What the clients were doing at host time ``t``."""
    n = len({u["client"] for u in units if u["t0"] <= t <= u["t1"]})
    return "%d of %d clients %s" % (n, clients, what)
