"""nums_tpu_torch: the port of nums_tpu to PyTorch and CUDA.

Arrays are grid-partitioned ``BlockArray``s held in one ``torch.Tensor``
each; ops are eager torch calls, and the TPU's Pallas kernels are CUDA
kernels written for Hopper (``nums_tpu_torch/csrc``), built at first use.
This package imports ``torch`` and never ``jax`` or ``nums_tpu``.
"""

from nums_tpu_torch.core import application_manager


def init():
    """Initialize the backend and return the ``ArrayApplication``."""
    return application_manager.instance()


__all__ = ["init"]
