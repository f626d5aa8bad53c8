"""Median over the window's dense requests of the ms they waited for
the daemon's op lock, their dispatch's and their resolve's
``lock_wait`` spans summed (``kma_tpu_torch.tracing``, program_span):
the lock that serialises every connection's device work
(``devserve.py``).  ``kmabench/spans.py`` says which requests."""

import statistics

from kmabench import spans


def read(res):
    p = spans.part(res)
    if p is None or not p.requests:
        return None
    return statistics.median(1e3 * spans.total(ss, "lock_wait")
                             for ss in p.requests.values())
