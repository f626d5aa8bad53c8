"""Share of the traced window (%) in which nothing ran on the card: 100
less the union of its operations' intervals (torch.profiler) over the
window's length.  One reader for every cell
(``device_idle_share.requests``, ``device_idle_share.samples``)."""


def read(res):
    t = res.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
