"""nums_tpu_torch: the port of nums_tpu to PyTorch and CUDA.

Arrays are grid-partitioned ``BlockArray``s held in one ``torch.Tensor``
each; ops are eager torch calls, and the TPU's Pallas kernels are CUDA
kernels written for Hopper (``nums_tpu_torch/csrc``), built at first use.
This package imports ``torch`` and never ``jax`` or ``nums_tpu``.
"""

from nums_tpu_torch.core import application_manager


def init(device=None):
    """Initialize the backend and return the ``ArrayApplication``.

    It runs on ``device``, by default ``cuda:0``, and raises
    ``RuntimeError`` where CUDA is missing: ``init(device="cpu")`` asks for
    the CPU. With a ``device``, a new application on it replaces any
    earlier one; without, an application that exists is returned."""
    if device is not None:
        application_manager.destroy()
        application_manager.set_instance(application_manager.create(device))
    return application_manager.instance()


__all__ = ["init"]
