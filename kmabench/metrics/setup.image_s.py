"""Seconds the daemon's dense image took to build, the ``image build``
of ``kma_tpu_torch.launch.start``'s split (``TorchDevServer.build_s``)."""


def read(res):
    return res.daemon.split.get("image build")
