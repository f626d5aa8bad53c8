"""Median over the window's dense requests of the daemon's host ms in
their resolve (``kma_tpu_torch.tracing``, program_span): the
``resolve`` span less its ``device_wait`` spans (the copies of the
outputs to the host, which wait for the card; the wide tier's chunks'
included), plus the ``pack`` span (the tie lists packed and the reply's
arrays), all under the op lock.  One reader for
``resolve_host_ms.requests`` and ``resolve_host_ms.samples``;
``kmabench/spans.py`` says which requests."""

import statistics

from kmabench import spans


def read(res):
    p = spans.part(res)
    if p is None or not p.requests:
        return None
    return statistics.median(
        1e3 * (spans.total(ss, "resolve", "pack")
               - spans.total(ss, "device_wait"))
        for ss in p.requests.values())
