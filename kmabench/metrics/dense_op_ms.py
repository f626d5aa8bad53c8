"""Median wall ms of the daemon's dense op over the window's requests
(``TorchDevServer.dense_ms``: dispatch plus resolve, the host's clock
inside the daemon).  Where the mix traces only its window's last
seconds, over the requests resolved before the profiler started, so
the number carries none of the profiler's cost.  One reader for every
cell: ``dense_op_ms.requests`` (the wire cells), ``dense_op_ms.samples``
(the sample-run cells)."""

import statistics


def read(res):
    ms = res.daemon.dense_ms
    return statistics.median(ms) if ms else None
