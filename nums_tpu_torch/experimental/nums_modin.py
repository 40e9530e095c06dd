"""DataFrame to BlockArray conversion (pandas and Modin).

Counterpart of ``nums_tpu/experimental/nums_modin.py``: the row
partitions are assembled into one host array and placed on the device
once; on a mesh backend each process assembles only the rows of its own
region (``filesystem.region_array``). ``from_pandas`` needs pandas; ``from_modin`` takes Modin's
row partitions where modin is importable and raises otherwise. Both are
imported inside the functions: importing this module imports neither.
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray


def _from_row_parts(parts, dtype=None, block_shape=None):
    """A list of 2-D row partitions as one BlockArray, in ``block_shape``
    or the application's default for the shape."""
    app = _instance()
    parts = [np.asarray(p) for p in parts]
    if dtype is None:
        dtype = np.result_type(*[p.dtype for p in parts])
        if dtype == object:
            dtype = np.float64
    rows = [p.shape[0] for p in parts]
    n, d = sum(rows), parts[0].shape[1]
    if block_shape is None:
        block_shape = app.get_block_shape((n, d), dtype)
    if app.backend.mesh is not None:
        from nums_tpu_torch.core.grid import ArrayGrid
        from nums_tpu_torch.core.io.filesystem import region_array

        starts = np.concatenate([[0], np.cumsum(rows)])

        def load_region(box):
            (r0, r1), (c0, c1) = box
            out = np.zeros((r1 - r0, c1 - c0), dtype=dtype)
            for p, s0, s1 in zip(parts, starts[:-1], starts[1:]):
                lo, hi = max(r0, s0), min(r1, s1)
                if lo < hi:
                    out[lo - r0:hi - r0] = p[lo - s0:hi - s0, c0:c1]
            return out

        grid = ArrayGrid((n, d), block_shape, np.dtype(dtype).name)
        return region_array(app.backend, grid, load_region)
    out = np.zeros((n, d), dtype=dtype)
    start = 0
    for p in parts:
        out[start:start + p.shape[0]] = p
        start += p.shape[0]
    return BlockArray.from_np(out, block_shape=block_shape,
                              backend=app.backend)


def from_pandas(df, dtype=None):
    """A pandas DataFrame (or Series) as a BlockArray."""
    import pandas as pd

    if isinstance(df, pd.Series):
        df = df.to_frame()
    assert isinstance(df, pd.DataFrame), type(df)
    arr = df.to_numpy()
    if arr.dtype == object and dtype is None:
        dtype = np.float64
    if dtype is not None:
        arr = arr.astype(dtype)
    return _from_row_parts([arr], dtype=arr.dtype)


def from_modin(df):
    try:
        import modin.pandas  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "modin is not available in this environment; install it to use "
            "nums_tpu_torch.experimental.nums_modin.from_modin (from_pandas "
            "works without)."
        ) from None
    # Modin's row partitions, one at a time, where this modin exposes
    # them; else the frame as one pandas frame.
    try:
        from modin.distributed.dataframe.pandas import unwrap_partitions

        row_parts = unwrap_partitions(df, axis=0)
        import ray

        parts = [
            np.asarray(
                (ray.get(p) if hasattr(p, "task_id") or hasattr(p, "hex")
                 else p).to_numpy()
            )
            for p in row_parts
        ]
        if parts:
            return _from_row_parts(parts)
    except Exception:  # noqa: BLE001 - any modin or ray version: one frame
        pass
    return from_pandas(df._to_pandas() if hasattr(df, "_to_pandas") else df)
