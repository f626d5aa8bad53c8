"""Share (%) of its least time that the run-scoring kernel
(``run_score_kernel``, csrc/scan_kernel.cu, behind ``run_score_rows``)
takes on the window's requests: the least time over the device time of
its launches in the traced window (torch.profiler).

The least time is the larger of its bytes at the H100 SXM's published
3.35 TB/s and its operations at the int32 rate of 132 SMs x 64 lanes x
1.98 GHz (a figure NVIDIA's data sheet does not give), by a frozen copy
of ``kma_tpu_torch.kernel_bench.run_score_bound``'s arithmetic (the
rows entry), counted from what the window's reads need once
(``reference.run_work`` on each request of the pool, times the sends
of it): score and first, [G, T] int32 written once (G two strand rows a
read, T the DB's templates), 16 bytes a live run, 8 a strand row, a
membership row (T / 8 bytes) a distinct list of a request; 10
operations a membership hit.  At these sizes the bytes bound it."""

PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9
RUN_OPS_PER_HIT = 10


def read(res):
    d, t = res.load, res.trace
    if t is None or not getattr(d, "pool_work", None):
        return None
    dev_s = sum(s for n, s in t["op_s"].items() if "run_score" in n)
    if dev_s <= 0:
        return None
    T = d.templates
    n_bytes = ops = 0
    for u in d.rec["units"]:
        runs, hits, lists = d.pool_work[u["pid"]]
        G = 2 * u["reads"]
        n_bytes += 8 * G * T + 16 * runs + 8 * G + T // 8 * lists
        ops += RUN_OPS_PER_HIT * hits
    least = max(n_bytes / PEAK_BYTES_S, ops / PEAK_INT_OPS_S)
    return 100.0 * least / dev_s
