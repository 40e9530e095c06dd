"""Shape and dtype helpers for the array layer.

Counterpart of ``nums_tpu/core/array/utils.py``: block-shape rules for
derived arrays and dtype names, plus the mapping between NumPy dtypes
(the names the grid metadata carries) and torch dtypes.
"""

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}
# torch's uint16, uint32 and uint64 hold data but have no arithmetic (no
# sum, product, division or shift kernels): the port refuses them with a
# TypeError that names the type, where the reference computes in them.
_UNSUPPORTED = (np.dtype(np.uint16), np.dtype(np.uint32),
                np.dtype(np.uint64))


def broadcast_shape(shape_a: tuple, shape_b: tuple) -> tuple:
    return tuple(np.broadcast_shapes(shape_a, shape_b))


def can_broadcast_shapes(shape_a: tuple, shape_b: tuple) -> bool:
    try:
        np.broadcast_shapes(shape_a, shape_b)
        return True
    except ValueError:
        return False


def broadcast_block_shape(
    result_shape: tuple,
    shape_a: tuple,
    bs_a: tuple,
    shape_b: tuple,
    bs_b: tuple,
) -> tuple:
    """Block shape of an elementwise result under NumPy broadcasting: the
    result inherits blocking from whichever operand spans each result
    axis, preferring the higher-rank operand."""
    ndim = len(result_shape)
    pad_a = ndim - len(shape_a)
    pad_b = ndim - len(shape_b)
    out = []
    for i, dim in enumerate(result_shape):
        cand = None
        ia = i - pad_a
        ib = i - pad_b
        a_spans = ia >= 0 and shape_a[ia] == dim and dim != 0
        b_spans = ib >= 0 and shape_b[ib] == dim and dim != 0
        if a_spans and (len(shape_a) >= len(shape_b) or not b_spans):
            cand = bs_a[ia]
        elif b_spans:
            cand = bs_b[ib]
        if cand is None or cand == 0:
            cand = dim
        out.append(min(cand, dim) if dim > 0 else 0)
    return tuple(out)


def reduced_block_shape(block_shape: tuple, axis, keepdims: bool) -> tuple:
    if axis is None:
        return tuple(1 for _ in block_shape) if keepdims else ()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % len(block_shape) for a in axes)
    out = []
    for i, b in enumerate(block_shape):
        if i in axes:
            if keepdims:
                out.append(1)
        else:
            out.append(b)
    return tuple(out)


def tensordot_block_shape(bs_a: tuple, bs_b: tuple, axes: int) -> tuple:
    if axes == 0:
        return tuple(bs_a) + tuple(bs_b)
    return tuple(bs_a[:-axes]) + tuple(bs_b[axes:])


def default_block_shape_for(shape: tuple, old_block_shape: tuple = None):
    if old_block_shape is not None and len(old_block_shape) == len(shape):
        return tuple(min(b, s) for b, s in zip(old_block_shape, shape))
    return tuple(shape)


def to_np_dtype(dtype) -> np.dtype:
    """NumPy dtype for a dtype-like: NumPy or torch dtype, python type."""
    if dtype is float:
        return np.dtype(np.float64)
    if dtype is int:
        return np.dtype(np.int64)
    if dtype is bool:
        return np.dtype(np.bool_)
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def to_dtype_name(dtype) -> str:
    """Canonical string name for a dtype-like."""
    if dtype is None:
        return None
    return to_np_dtype(dtype).name


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype-like; ``TypeError`` for a dtype the port
    does not hold (uint16/32/64, strings, objects...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    np_dtype = to_np_dtype(dtype)
    if np_dtype not in _NP_TO_TORCH:
        why = (" (torch has no arithmetic for it; use int64)"
               if np_dtype in _UNSUPPORTED else "")
        raise TypeError(f"nums_tpu_torch does not support dtype "
                        f"{np_dtype.name}{why}")
    return _NP_TO_TORCH[np_dtype]


def is_scalar_like(x) -> bool:
    return isinstance(x, (bool, int, float, complex, np.generic)) or (
        isinstance(x, np.ndarray) and x.ndim == 0
    )


def shape_from_block_shape(shape: tuple, block_shape: tuple) -> tuple:
    """The grid shape implied by (shape, block_shape)."""
    return tuple(-(-s // b) if s > 0 else 1
                 for s, b in zip(shape, block_shape))
