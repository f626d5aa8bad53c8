"""Seconds of the daemon's warm-up, the ``warm-up`` of
``kma_tpu_torch.launch.start``'s split: ``TorchDevServer.warm()``,
which captures the scan step's and the chain op's graphs."""


def read(res):
    return res.daemon.split.get("warm-up")
