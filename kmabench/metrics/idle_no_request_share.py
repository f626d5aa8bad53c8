"""Share (%) of the window's part (``kmabench/spans.py``) in which no
batch ran on the card (no ``device`` span open) and no connection was
in ``recv``, ``lock_wait``, ``dispatch``, ``resolve``, ``pack`` or an
op (``kma_tpu_torch.tracing``, program_span): the daemon waited on its
clients, here the native CLIs' host side.  ``idle_no_request_share.
samples``."""

from kmabench import spans


def read(res):
    p = spans.part(res)
    if p is None or p.w1 <= p.w0:
        return None
    return spans.share(
        p, {"busy": ("device", "recv", "lock_wait", "dispatch", "resolve",
                     "pack") + spans.OPS},
        lambda n: not n["busy"])
