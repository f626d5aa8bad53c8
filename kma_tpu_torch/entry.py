"""The port's counterpart of the root ``__graft_entry__.py``.

``entry(device=None)`` returns ``(fn, example_args)`` as the JAX
``entry()`` does: ``fn`` is the production dense step
(``mapping.scan_dense.dense_scan_device``) as a pure function of its
device tensors, its statics bound as ``_dense_fn`` binds them, on the
JAX package's tiny problem (8 templates of 200 bp, 8 reads of 48 bp,
k 16, seed 0) with the index built by the port's own code.  The JAX
step certifies that it is jittable; the port's certifies that it has
static shapes and no host sync, so that ``capture`` can take it whole
into one CUDA graph and replay it, as the daemon's dense op replays one
graph of it a static shape (``mapping.scan_dense.StepGraphs``: the same
step, ``DenseScanner.step``, captured by ``capture``).
``dryrun_multichip`` is
``parallel/multichip.py``'s.

``fn(codes, lengths, exist, kv, bits)`` takes the port's image tensors:
the JAX step's sixth array, the transposed ``bits_t``, served the TPU
layout the port dropped.  On the card it launches ``run_score_rows``;
on the CPU it takes the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .config import Penalties
from .device import DeviceLike, resolve
from .mapping.scan_dense import TIERS, DenseIndex, DenseScanner
from .parallel.multichip import dryrun_multichip, synthetic_index

__all__ = ["entry", "dense_step", "capture", "tiny_problem",
           "dryrun_multichip"]

K = 16
TEMPLATE_LEN = 200
#: eager calls on a side stream before a capture (PyTorch's recipe: the
#: caching allocator and the kernel library are warm when it starts)
WARMUP = 2


def tiny_problem(n_templates: int = 8, n_reads: int = 8,
                 read_len: int = 48, seed: int = 0):
    """``__graft_entry__._tiny_problem``'s DB and reads, draw for draw
    from the same generator: (index, codes [n, L] uint8, lengths [n]
    int32, templates)."""
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, 4, TEMPLATE_LEN).astype(np.uint8)
                 for _ in range(n_templates)]
    codes = np.full((n_reads, read_len), 4, dtype=np.uint8)
    lengths = np.full(n_reads, read_len, dtype=np.int32)
    for i in range(n_reads):
        src = templates[i % n_templates]
        s = rng.integers(0, len(src) - read_len)
        codes[i] = src[s: s + read_len]
    return synthetic_index(templates, K), codes, lengths, templates


def dense_step(scanner: DenseScanner, B: int, L: int, tier: int = 1,
               flat_cap: int = None) -> Callable:
    """``dense_scan_device`` of a [B, L] batch at ``tier``'s caps as a
    pure function of (codes, lengths, exist, kv, bits), on the tensors'
    own device: ``scanner.step``, the function the daemon's step graphs
    capture for a batch of that tier (the scanner's statics: ``_sparams``,
    ``small_ids``, its ``proxi_frac``; tier 0 merged, tier 1 unmerged).
    ``flat_cap`` defaults to the daemon's: ``flat_headroom`` ids a read
    at tier 0, a chunk's worst case at tier 1 (``wide_chunks``)."""
    if flat_cap is None:
        flat_cap = scanner.flat_headroom * B if tier == 0 \
            else 2 * min(TIERS[1][1], scanner.didx.t_pad) * B
    return scanner.step(L, tier, flat_cap)


def image_args(didx: DenseIndex, codes: np.ndarray, lengths: np.ndarray,
               device: DeviceLike) -> Tuple[torch.Tensor, ...]:
    """(codes, lengths, exist, kv, bits) of an unsharded image on
    ``device``."""
    dev = resolve(device)
    return (torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(lengths, np.int32)
                             ).to(dev),
            didx.exist.to(dev), didx.kv.to(dev), didx.bits.to(dev))


def entry(device: DeviceLike = None):
    """(fn, example_args): the production dense step on the tiny
    problem, as ``__graft_entry__.entry()``.  ``device`` None is the
    CUDA card (raising without one); the CPU tests pass "cpu"."""
    dev = resolve(device)
    idx, codes, lengths, _ = tiny_problem()
    pen = Penalties()
    scanner = DenseScanner(idx, pen, batch=len(codes), device=dev)
    B, L = codes.shape
    fn = dense_step(scanner, B, L, tier=1, flat_cap=24 * B)
    return fn, image_args(scanner.didx, codes, lengths, dev)


#: each card's capture stream (``capture_stream``)
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The stream every capture on the card ``dev`` runs on.  One a card:
    blocks a capture frees in a shared pool are reused only by captures
    on the same stream (the caching allocator keeps free blocks by
    stream), and ``torch.cuda.graph``'s own default is one stream for
    the process, on the card it was first made on."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[i] = torch.cuda.Stream(torch.device("cuda", i))
    return _CAPTURE_STREAMS[i]


def capture(fn: Callable, args, pool=None):
    """``fn(*args)`` taken whole into one ``torch.cuda.CUDAGraph``:
    WARMUP eager calls on a side stream, then the capture, whose
    allocations come from the graph's own pool, or from ``pool``
    (``torch.cuda.graph_pool_handle()``) shared with other graphs.
    Returns (graph, the graph's output tensors); ``graph.replay()``
    reruns the step on the tensors of ``args`` as they then hold, into
    those outputs.  Raises when the step syncs the host or leaves the
    capturing stream.  The one place the port captures: the daemon's
    step graphs (``mapping.scan_dense.StepGraphs``) call it, once for
    each segment of a sharded step, on the segment's card."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError("capture: tensors on %s, not a CUDA card" % dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn(*args)
    stream = torch.cuda.current_stream(dev)
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=pool, stream=capture_stream(dev)):
            out: List[torch.Tensor] = fn(*args)
    finally:
        # a capture that fails can raise in torch.cuda.graph's exit
        # before it makes the caller's stream current again
        torch.cuda.set_stream(stream)
    return graph, out
