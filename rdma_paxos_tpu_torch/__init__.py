"""PyTorch/CUDA port of the rdma_paxos_tpu consensus core.

A second package beside the JAX reference (``rdma_paxos_tpu``), with
the same module layout. It imports torch and numpy, never JAX and never
the JAX package. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; without a card and without that argument they
raise. The one TPU kernel of the reference, the quorum commit scan, is
a hand-written CUDA kernel here (``csrc/commit_scan.cu``), built with
``nvcc`` at first use.
"""

__version__ = "0.1.0"

__all__ = ["LogConfig", "resolve_device"]


def __getattr__(name):
    # resolved on first use, so that importing a stdlib-only subpackage
    # (``analysis``, whose CLI runs before anything heavy) loads no torch
    if name in __all__:
        from rdma_paxos_tpu_torch import config
        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
