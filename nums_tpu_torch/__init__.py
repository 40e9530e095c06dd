"""nums_tpu_torch: the port of nums_tpu to PyTorch and CUDA.

Arrays are grid-partitioned ``BlockArray``s held in one ``torch.Tensor``
each; ops are eager torch calls, and the TPU's Pallas kernels are CUDA
kernels written for Hopper (``nums_tpu_torch/csrc``), built at first use.
This package imports ``torch`` and never ``jax`` or ``nums_tpu``.
"""

from nums_tpu_torch._version import __version__
from nums_tpu_torch.api import (delete, read, read_csv, read_parquet, write,
                                write_parquet)
from nums_tpu_torch.core import application_manager


def init(device=None, backend=None, cluster_shape=None):
    """Initialize the backend and return the ``ArrayApplication``.

    It runs on ``device``, by default ``cuda:0`` (on the mesh, the card of
    this process's local rank), and raises ``RuntimeError`` where CUDA is
    missing: ``init(device="cpu")`` asks for the CPU. ``backend`` is
    ``"serial"`` or ``"mesh"`` (default ``settings.backend_name``), and
    ``cluster_shape`` the mesh's shape, whose product must be the number
    of processes. With any argument, a new application replaces any
    earlier one; without, an application that exists is returned."""
    if device is not None or backend is not None or cluster_shape is not None:
        application_manager.destroy()
        application_manager.set_instance(application_manager.create(
            device, backend=backend, cluster_shape=cluster_shape))
    return application_manager.instance()


__all__ = ["read", "write", "delete", "read_csv", "read_parquet",
           "write_parquet", "init", "__version__"]
