"""The native block I/O engine (``csrc/shard_io.cpp``), bound with ctypes.

Counterpart of ``nums_tpu/core/io/shard_native.py``. ``write_shards`` and
``read_block_windows`` keep the format of the numpy route (one standard
``.npy`` per block, its header built with ``numpy.lib.format``), so a
checkpoint moves between the two routes and opens with ``np.load``. The
C++ thread pool does the file I/O with the GIL released. The library is
built at first use into ``nums_tpu_torch/_build/`` under a name that
carries a hash of its source; without a compiler ``get_lib`` returns None,
both functions return False and the callers take ``np.save``/``np.load``.
"""

import ctypes
import io
import os
import threading

import numpy as np

from nums_tpu_torch.core.ops import _build

_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build.host_library("shard_io.cpp", "nums_shard",
                                 libs=("-lpthread",))
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        pp = ctypes.POINTER(ctypes.c_char_p)
        pl = ctypes.POINTER(ctypes.c_long)
        pb = ctypes.POINTER(ctypes.c_void_p)
        lib.nums_write_shards.restype = ctypes.c_long
        lib.nums_write_shards.argtypes = [pp, pb, pl, pb, pl,
                                          ctypes.c_long, ctypes.c_int]
        lib.nums_read_regions.restype = ctypes.c_long
        lib.nums_read_regions.argtypes = [pp, pl, pl, pl, pl, pb, pl,
                                          ctypes.c_long, ctypes.c_int]
        _lib = lib
        return _lib


def _npy_header(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr)
    )
    return buf.getvalue()


def _threads(n: int) -> int:
    return min(16, max(1, os.cpu_count() or 1), n)


def write_shards(items, threads=None) -> bool:
    """Write [(path, np.ndarray), ...] as ``.npy`` files on parallel C
    threads. Returns False (the caller then takes ``np.save``) without
    the library, for no items and for an object array."""
    lib = get_lib()
    if lib is None or not items:
        return False
    arrays = []
    for _, a in items:
        if a.dtype.hasobject:
            return False
        arrays.append(np.ascontiguousarray(a))
    headers = [_npy_header(a) for a in arrays]
    n = len(items)
    paths = (ctypes.c_char_p * n)(*[p.encode() for p, _ in items])
    hbufs = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(h), ctypes.c_void_p) for h in headers]
    )
    hlens = (ctypes.c_long * n)(*[len(h) for h in headers])
    dbufs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
    )
    dlens = (ctypes.c_long * n)(*[a.nbytes for a in arrays])
    rc = lib.nums_write_shards(
        ctypes.cast(paths, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(hbufs, ctypes.POINTER(ctypes.c_void_p)),
        hlens,
        ctypes.cast(dbufs, ctypes.POINTER(ctypes.c_void_p)),
        dlens, n, threads or _threads(n),
    )
    # The header bytes and the arrays stay alive through the call.
    del headers, arrays
    return rc == 0


def npy_layout(path):
    """(data offset, shape, fortran order, dtype) of a ``.npy`` file, or
    None when its header does not read."""
    fmt = np.lib.format
    try:
        with open(path, "rb") as f:
            version = fmt.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = fmt.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = fmt.read_array_header_2_0(f)
            else:
                return None
            return f.tell(), shape, fortran, dtype
    except Exception:  # noqa: BLE001 - any unreadable header: numpy route
        return None


def read_block_windows(jobs, out: np.ndarray, threads=None) -> bool:
    """Parallel strided window reads into ``out``.

    jobs: [(path, src slices, dst slices)]: the window ``src`` of the
    block stored at ``path`` lands at ``dst`` of ``out``. Takes C-ordered
    1-D and 2-D blocks of ``out``'s dtype; returns False otherwise, and
    when any read fails, for the caller to load whole blocks. A window of
    whole rows is read in one piece (nums_tpu's reads it row by row)."""
    lib = get_lib()
    if lib is None or not jobs:
        return False
    if not out.flags["C_CONTIGUOUS"] or out.ndim not in (1, 2):
        return False
    if out.dtype.hasobject:  # a pickle's bytes are no object pointers
        return False
    item = out.itemsize
    paths, offs, rbytes, nrows, sstride, dsts, dstride = (
        [], [], [], [], [], [], []
    )
    base = out.ctypes.data
    for path, src, dst in jobs:
        layout = npy_layout(path)
        if layout is None:
            return False
        data_off, shape, fortran, dtype = layout
        if fortran or dtype != out.dtype or len(shape) != out.ndim:
            return False
        if out.ndim == 1:
            (s,), (d,) = src, dst
            offs.append(data_off + s.start * item)
            rbytes.append((s.stop - s.start) * item)
            nrows.append(1)
            sstride.append(0)
            dsts.append(base + d.start * item)
            dstride.append(0)
        else:
            (sr, sc), (dr, dc) = src, dst
            src_row = shape[1] * item
            dst_row = out.shape[1] * item
            offs.append(data_off + sr.start * src_row + sc.start * item)
            dsts.append(base + dr.start * dst_row + dc.start * item)
            if sc.stop - sc.start == shape[1] == out.shape[1]:
                # Whole rows of the block and of ``out``: the window is
                # one run of bytes in both, one read and not one a row.
                rbytes.append((sr.stop - sr.start) * src_row)
                nrows.append(1)
                sstride.append(0)
                dstride.append(0)
            else:
                rbytes.append((sc.stop - sc.start) * item)
                nrows.append(sr.stop - sr.start)
                sstride.append(src_row)
                dstride.append(dst_row)
        paths.append(path.encode())
    n = len(paths)
    rc = lib.nums_read_regions(
        ctypes.cast((ctypes.c_char_p * n)(*paths),
                    ctypes.POINTER(ctypes.c_char_p)),
        (ctypes.c_long * n)(*offs),
        (ctypes.c_long * n)(*rbytes),
        (ctypes.c_long * n)(*nrows),
        (ctypes.c_long * n)(*sstride),
        ctypes.cast((ctypes.c_void_p * n)(*dsts),
                    ctypes.POINTER(ctypes.c_void_p)),
        (ctypes.c_long * n)(*dstride),
        n, threads or _threads(n),
    )
    return rc == 0
