"""PyTorch/CUDA port of the rdma_paxos_tpu consensus core.

A second package beside the JAX reference (``rdma_paxos_tpu``), with
the same module layout. It imports torch and numpy, never JAX and never
the JAX package. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; without a card and without that argument they
raise. The one TPU kernel of the reference, the quorum commit scan, is
a hand-written CUDA kernel here (``csrc/commit_scan.cu``), built with
``nvcc`` at first use.
"""

from rdma_paxos_tpu_torch.config import LogConfig, resolve_device

__all__ = ["LogConfig", "resolve_device"]
