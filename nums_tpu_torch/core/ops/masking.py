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
    the counts; NaNs sort last, as in ``jnp.unique``."""
    x = block_array.data
    flat = x.reshape(-1)
    s, perm = torch.sort(flat, stable=True)
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
