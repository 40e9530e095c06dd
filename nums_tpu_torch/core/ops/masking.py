"""Device-side boolean-mask and unique resolution.

Counterpart of ``nums_tpu/core/ops/masking.py``. The index arrays of a
mask and the distinct values of an array are built on the device; the one
host sync is the count that sizes them (``torch.nonzero`` reads it; the
reference reads it as a scalar and pads its jitted programs to a power of
two, which only bounds jax's retraces and has no use here). The port keeps
no at-rest padding, so the reference's ``_logical`` reduces to the lazy
transpose, which ``BlockArray.data`` already applies as a view.
"""

import torch


# torch.nonzero refuses a CUDA tensor of more elements than int32 indexes.
NONZERO_MAX_ELEMENTS = 2**31 - 1


def refuse_dtensor(tensor, op: str):
    """A data-dependent shape has no DTensor sharding strategy: where a
    DTensor reaches this module's device ops (a device mask in a key that
    ``BlockArray._device_key`` does not take: after a slice, say; every
    other mask takes ``core/ops/mesh_ops.py``), ``op`` raises
    ``NotImplementedError`` naming it, and never gathers the array to one
    process."""
    from torch.distributed.tensor import DTensor

    if isinstance(tensor, DTensor):
        raise NotImplementedError(
            f"{op}: DTensor has no sharding strategy for it (a device mask "
            "in a key of another form than index arrays on the leading "
            "axes, on the mesh)")


def _flat_nonzero(flat):
    """Positions of the True elements of a 1-D bool tensor, int64, in
    order; a tensor longer than ``NONZERO_MAX_ELEMENTS`` a chunk at a time
    (one host sync a chunk)."""
    if flat.numel() <= NONZERO_MAX_ELEMENTS:
        return torch.nonzero(flat, as_tuple=True)[0]
    parts = [torch.nonzero(flat[i:i + NONZERO_MAX_ELEMENTS],
                           as_tuple=True)[0] + i
             for i in range(0, flat.numel(), NONZERO_MAX_ELEMENTS)]
    return torch.cat(parts)


def device_where(mask_block_array):
    """(count, index tensors): ``np.where`` of a BlockArray on its device,
    one index tensor per axis, int64, in row-major order; one host sync
    for the count (one a chunk above ``NONZERO_MAX_ELEMENTS`` elements)."""
    data = mask_block_array.data.to(torch.bool)
    refuse_dtensor(data, "aten.nonzero")
    if data.numel() <= NONZERO_MAX_ELEMENTS:
        idx = torch.nonzero(data, as_tuple=True)
    else:
        flat = _flat_nonzero(data.reshape(-1))
        idx = []
        for size in reversed(data.shape):
            idx.append(torch.remainder(flat, size))
            flat = torch.div(flat, size, rounding_mode="floor")
        idx = tuple(reversed(idx))
    count = int(idx[0].shape[0]) if idx else 0
    return count, tuple(idx)


def argsort(x, dim=-1, descending=False):
    """Stable argsort in jnp's order along ``dim``: NaN last, and complex
    numbers by real part, then imaginary part (a stable sort on the
    imaginary part, then a stable sort of that order on the real part;
    torch sorts no complex tensor)."""
    if not x.is_complex():
        return torch.argsort(x, dim=dim, stable=True, descending=descending)
    perm = torch.argsort(x.imag, dim=dim, stable=True, descending=descending)
    real = torch.gather(x.real, dim, perm)
    return torch.gather(perm, dim, torch.argsort(
        real, dim=dim, stable=True, descending=descending))


def sort(x, dim=-1, descending=False):
    """(values, indices) of ``argsort``'s order."""
    if not x.is_complex():
        return tuple(torch.sort(x, dim=dim, stable=True,
                                descending=descending))
    perm = argsort(x, dim, descending)
    return torch.gather(x, dim, perm), perm


def _total_lt(a, b):
    """``a < b`` with NaN above every number (jax's sort comparator)."""
    return (a < b) | (~torch.isnan(a) & torch.isnan(b))


def _complex_lt(a, b):
    """jax's sort comparator on complex numbers: the real parts, then the
    imaginary parts, each with NaN above every number."""
    same = (a.real == b.real) | (torch.isnan(a.real) & torch.isnan(b.real))
    return _total_lt(a.real, b.real) | (same & _total_lt(a.imag, b.imag))


INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def total_order_key(x):
    """Integers in the order of jax's sort comparator on floats: -0 as 0,
    every NaN as one NaN above +inf; the bits of a float read as a signed
    integer, the negative ones with their magnitude bits flipped."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    dt = INT_OF_WIDTH[x.dtype.itemsize]
    bits = x.view(dt)
    return bits ^ ((bits >> (8 * x.dtype.itemsize - 1))
                   & torch.iinfo(dt).max)


def searchsorted(seq, values, right=False):
    """``jnp.searchsorted`` of a 1-D sorted ``seq`` in jax's sort order:
    floats through ``total_order_key`` (torch's own search is lost where
    NaN is in either operand), a complex ``seq`` by a binary search, one
    comparison per halving, as jax's own ``scan`` method (torch's has no
    complex kernel)."""
    if seq.is_floating_point():
        seq, values = total_order_key(seq), total_order_key(values)
    if not seq.is_complex():
        return torch.searchsorted(seq.contiguous(), values.contiguous(),
                                  right=right)
    n = seq.shape[0]
    lo = torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        pivot = seq[mid.clamp(max=n - 1)]
        # left: past every element below the value; right: past every
        # element not above it
        below = (~_complex_lt(values, pivot) if right
                 else _complex_lt(pivot, values))
        go_right = active & below
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def _distinct_starts(s, equal_nan):
    """True where a sorted 1-D tensor starts a run of equal values; NaNs
    form one run when ``equal_nan``, else each its own."""
    starts = torch.ones_like(s, dtype=torch.bool)
    if s.numel() > 1:
        neq = s[1:] != s[:-1]
        if equal_nan and (s.is_floating_point() or s.is_complex()):
            neq = neq & ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
        starts[1:] = neq
    return starts


def device_unique(block_array, want_index=False, want_inverse=False,
                  want_counts=False, equal_nan=True):
    """``np.unique`` of a non-empty BlockArray on its device: one host sync
    (the distinct count). Returns (count, [values, index?, inverse?,
    counts?]): the index of each value's first occurrence (a stable sort
    keeps equal values in input order), the inverse in the input's shape,
    the counts; NaNs sort last, and complex values in ``argsort``'s order,
as in ``jnp.unique``."""
    x = block_array.data
    flat = x.reshape(-1)
    if flat.is_complex():
        # jnp.unique takes every complex NaN as nan+0j
        flat = torch.where(torch.isnan(flat), flat.new_tensor(complex(
            float("nan"), 0.0)), flat)
    s, perm = sort(flat)
    starts = _distinct_starts(s, equal_nan)
    first = _flat_nonzero(starts)
    count = int(first.shape[0])
    outs = [s[first]]
    if want_index:
        outs.append(perm[first])
    if want_inverse:
        run = torch.cumsum(starts.to(torch.int64), 0) - 1
        inv = torch.empty_like(run)
        inv[perm] = run
        outs.append(inv.reshape(tuple(x.shape)))
    if want_counts:
        ends = torch.cat([first[1:], first.new_tensor([flat.numel()])])
        outs.append(ends - first)
    return count, outs
