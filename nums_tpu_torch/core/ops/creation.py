"""Array creation as plain torch calls.

Counterpart of ``nums_tpu/core/ops/creation.py``: each creator allocates
the whole array on the backend's device in one call (the reference
compiles one program per creator into its target sharding).
"""

import torch

_CREATORS = {
    "zeros": torch.zeros,
    "ones": torch.ones,
    # The reference's empty is zeros (XLA has no uninitialized alloc):
    # keep its values.
    "empty": torch.zeros,
}


def new_array(op_name: str, shape: tuple, dtype: torch.dtype, device):
    return _CREATORS[op_name](tuple(shape), dtype=dtype, device=device)


def full(shape: tuple, fill_value, dtype: torch.dtype, device):
    return torch.full(tuple(shape), fill_value, dtype=dtype, device=device)


def eye(shape: tuple, dtype: torch.dtype, device, k: int = 0):
    """Ones on the k-th diagonal (k > 0 above the main one), as
    ``numpy.eye``."""
    rows, cols = shape
    if k == 0:
        return torch.eye(rows, cols, dtype=dtype, device=device)
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return (j - i == k).to(dtype)


def arange(start: int, stop: int, step: int, dtype: torch.dtype, device):
    return torch.arange(start, stop, step, dtype=dtype, device=device)


def linspace(start, stop, num: int, endpoint: bool, dtype: torch.dtype,
             device):
    """``linspace`` along axis 0 in the reference's form: the lerp
    ``start * (1 - t) + stop * t`` with ``t = i / div`` (``div`` is ``num -
    1`` with the endpoint, else ``num``), which recovers both ends exactly,
    computed in ``dtype`` (float64 for an integer ``dtype``, then floored)
    and the last point set to ``stop`` itself."""
    work = dtype if dtype.is_floating_point else torch.float64
    start = torch.tensor(start, dtype=work, device=device)
    stop = torch.tensor(stop, dtype=work, device=device)
    div = (num - 1) if endpoint else num
    if num > 1:
        t = torch.arange(div, dtype=work, device=device) / div
        out = start * (1 - t) + stop * t
        if endpoint:
            out = torch.cat([out, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return out.to(dtype)


def diag(x):
    """Vector to diagonal matrix, or square matrix to its diagonal."""
    return torch.diag(x)
