"""The NumPy-style facade of nums_tpu_torch.

Counterpart of ``nums_tpu/numpy``. Only ``random`` is here so far
(``nums_tpu_torch.numpy.random``, the ``np.random`` surface); the array
API modules (``api``, ``extra*``, ``tail``, ``compat``, ``linalg``,
``fft``) follow with the rest of the array layer.
"""

from nums_tpu_torch.numpy import random

__all__ = ["random"]
