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
        is never aliased). Where the default float is float32 (an
        accelerator), float64 and complex128 arrive as float32 and
        complex64, as the reference's device_put with x64 off does: a
        host scalar such as ``app.one`` then keeps float32 math float32."""
        del grid
        array = np.array(array, order="C", copy=True)
        if self.default_float == np.float32:
            narrow = {np.dtype(np.float64): np.float32,
                      np.dtype(np.complex128): np.complex64}
            if array.dtype in narrow:
                array = array.astype(narrow[array.dtype])
        return torch.from_numpy(array).to(self.device)

    def get(self, tensor) -> np.ndarray:
        return tensor.detach().cpu().numpy()


class SerialBackend(Backend):
    """Single-device backend on an explicit ``torch.device``. The default
    device is ``cuda:0``; where CUDA is missing, ``init`` raises: the CPU
    runs only when the caller asks for it (``device="cpu"``)."""

    name = "serial"

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def init(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "nums_tpu_torch: no CUDA device (torch.cuda.is_available()"
                    " is false); to run on the CPU, ask for it: "
                    "nums_tpu_torch.init(device=\"cpu\")"
                )
            self.device = torch.device("cuda:0")
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
