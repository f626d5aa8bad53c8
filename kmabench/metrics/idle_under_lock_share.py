"""Share (%) of the window's part (``kmabench/spans.py``) in which no
batch ran on the card (no ``device`` span open: each batch's step from
the host's return from launching it to a CUDA event after it, on the
host's clock) while a connection held the daemon's op lock (a
``dispatch``, ``resolve``, ``pack`` or op span) outside a
``device_wait`` (``kma_tpu_torch.tracing``, program_span): the card
idle for the daemon's host work under its lock, its graph launches
among it.  Read as ``idle_under_lock_share.requests``, where the
batches' kernels outlast their launches; where a batch's kernels run
inside its launch (the panel's short steps) the share reads high."""

from kmabench import spans


def read(res):
    p = spans.part(res)
    if p is None or p.w1 <= p.w0:
        return None
    return spans.share(
        p, {"held": ("dispatch", "resolve", "pack") + spans.OPS,
            "wait": ("device_wait",), "card": ("device",)},
        lambda n: n["held"] and not n["wait"] and not n["card"])
