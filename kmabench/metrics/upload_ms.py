"""Median over the window's dense requests of the ms their batches'
``upload`` spans sum to (``kma_tpu_torch.tracing``, program_span): each
batch padded on the host and copied to the card
(``mapping/scan_common.py`` ``_padded``), tier 0 and the wide tier.  A
pageable copy that waits for the card's stream to drain reads here.
One reader for ``upload_ms.requests`` and ``upload_ms.samples``;
``kmabench/spans.py`` says which requests."""

import statistics

from kmabench import spans


def read(res):
    p = spans.part(res)
    if p is None or not p.requests:
        return None
    return statistics.median(1e3 * spans.total(ss, "upload")
                             for ss in p.requests.values())
