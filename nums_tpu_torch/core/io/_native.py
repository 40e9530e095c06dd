"""The native CSV parser (``csrc/csv_parser.cpp``), bound with ctypes.

Counterpart of ``nums_tpu/core/io/_native.py``. The library is built by
the host C++ compiler at first use into ``nums_tpu_torch/_build/`` under
a name that carries a hash of its source. The C call releases the GIL, so
the thread pool of ``FileSystem.read_csv_host`` parses byte ranges on
real parallel threads. Without a compiler ``get_lib`` returns None and
the callers parse with ``np.loadtxt``.
"""

import ctypes
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
        so = _build.host_library("csv_parser.cpp", "nums_csv")
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.nums_parse_csv.restype = ctypes.c_long
        lib.nums_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return _lib


def count_values(data: bytes, delimiter: str) -> int:
    """The exact value count of delimiter-separated numeric text: one
    value per delimiter plus one per row (ended by a newline, or the last
    line without one). It sizes the output buffer exactly; blank lines and
    trailing delimiters make it an upper bound."""
    if not data:
        return 0
    d = delimiter.encode()[0:1]
    rows = data.count(b"\n")
    if not data.endswith(b"\n"):
        rows += 1
    return data.count(d) + rows


def parse_bytes_into(data: bytes, delimiter: str, out):
    """Parse into a caller's contiguous float64 buffer (a slice of one
    file-wide array, so the ranges assemble without a concatenation).
    Returns (n_values, n_rows, n_cols, ok); ok is False without the
    library, on a non-numeric field and on ragged rows."""
    lib = get_lib()
    if lib is None or not data:
        return 0, 0, 0, False
    assert out.dtype == np.float64 and out.flags.c_contiguous, out.dtype
    n_rows = ctypes.c_long(0)
    n_cols = ctypes.c_long(0)
    n = lib.nums_parse_csv(
        data, len(data), delimiter.encode()[0:1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.size, ctypes.byref(n_rows), ctypes.byref(n_cols),
    )
    if n < 0 or n_cols.value == 0:
        return 0, 0, 0, False
    if n_rows.value * n_cols.value != n:
        return 0, 0, 0, False
    return n, n_rows.value, n_cols.value, True


def parse_bytes(data: bytes, delimiter: str):
    """Delimiter-separated numeric text as (2-D float64 array, True), or
    (None, False) without the library or when the text is not purely
    numeric: the caller then parses with ``np.loadtxt``."""
    if get_lib() is None or not data:
        return None, False
    out = np.empty(max(64, count_values(data, delimiter)), np.float64)
    n, rows, cols, ok = parse_bytes_into(data, delimiter, out)
    if not ok:
        return None, False
    return out[:n].reshape(rows, cols), True
