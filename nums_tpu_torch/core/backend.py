"""Execution backend: where arrays live.

Counterpart of ``Backend`` and ``SerialBackend`` in
``nums_tpu/core/backend.py:25-161``. An array is ONE ``torch.Tensor`` on
the backend's ``torch.device``; every op is a torch call on it. The
at-rest shape equals the logical shape: the reference pads the minor
axis to the TPU's 128 lanes, and nothing here needs that.
"""

import numpy as np
import torch

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.grid import ArrayGrid


class Backend:
    """Common backend interface."""

    name = None

    def init(self):
        return self

    def shutdown(self):
        pass

    @property
    def num_devices(self):
        raise NotImplementedError

    @property
    def num_cores_total(self):
        # Drives the block-shape policy: "cores" are devices.
        return self.num_devices

    @property
    def default_float(self) -> np.dtype:
        return settings.default_float_for(self.device)

    def device_put(self, array: np.ndarray, grid: ArrayGrid = None):
        """Host array -> tensor on the device (copied: the caller's array
        is never aliased)."""
        del grid
        tensor = torch.from_numpy(np.array(array, order="C", copy=True))
        return tensor.to(self.device)

    def get(self, tensor) -> np.ndarray:
        return tensor.detach().cpu().numpy()


class SerialBackend(Backend):
    """Single-device backend on an explicit ``torch.device``. The default
    device is ``cuda:0`` when CUDA exists and ``cpu`` otherwise, as the
    reference takes ``jax.devices()[0]``."""

    name = "serial"

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def init(self):
        if self.device is None:
            self.device = torch.device(
                "cuda:0" if torch.cuda.is_available() else "cpu"
            )
        return self

    @property
    def num_devices(self):
        return 1


_BACKENDS = {"serial": SerialBackend}


def make_backend(name: str = None, **kwargs) -> Backend:
    name = name or settings.backend_name
    if name not in _BACKENDS:
        raise ValueError(
            f"Unknown backend {name!r}; expected one of {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name](**kwargs).init()
