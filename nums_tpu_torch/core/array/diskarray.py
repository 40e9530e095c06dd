"""Out-of-core arrays: a block checkpoint on disk, read one row panel at a
time.

Counterpart of ``nums_tpu/core/array/diskarray.py``. A ``DiskArray`` is a ``write_fs`` directory (one ``.npy`` per grid block and
``meta.pkl``, with the replicas and CRCs of ``core/io/filesystem.py``)
viewed as an array. The streamed ops (``ArrayApplication.*_ooc`` and the
GLMs' out-of-core fits) read its row panels on the host, a prefetch thread
loading the next panel from disk while the device works on the current
one, and move each to the device: device memory holds one panel and the
accumulators, so a dataset larger than the card's memory streams through
it.

Usage::

    dX = app.spill(X, "bigX")        # BlockArray -> disk
    dX = app.open_fs("bigX")         # an existing checkpoint
    G = app.gram_ooc(dX)             # XᵀX, one streamed pass
    model.fit(dX, y)                 # GLMs train out of core

Under several processes each process streams only its own rows of each
panel: ``iter_panel_refs`` yields lazy ``PanelRef``s, whose ``load(lo,
hi)`` reads just those rows through a memory map, so P processes each
read 1/P of the file. ``from_panels`` is then collective: every process
drains the panel stream (it may hold collectives), process 0 writes, and
every process opens the result.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.io import filesystem as _fs


# Bytes this process has read through ``PanelRef.load`` (the rows of its
# regions of the panels): a reader sets it to 0 and reads it back.
PANEL_BYTES_READ = {"bytes": 0}


class PanelRef:
    """A lazy handle to one row panel of a DiskArray: its shape and dtype,
    and the rows [lo, hi) on request, read through the memory-mapped
    primaries (``DiskArray._mmap_block``: only the pages of those rows),
    with the replica failover and CRCs of a full load where a primary does
    not open. Nothing is read until ``load`` or ``full``."""

    def __init__(self, da, panel_index: int, nrows: int):
        self._da = da
        self._i = int(panel_index)
        self.shape = (nrows,) if da.ndim == 1 else (nrows, da.shape[1])
        self.dtype = da.dtype

    def full(self) -> np.ndarray:
        """The whole panel (``DiskArray.row_panel``)."""
        return self._da.row_panel(self._i)

    def load(self, lo: int, hi: int) -> np.ndarray:
        """Host rows [lo, hi) of this panel (panel-relative), read now into
        a C-ordered array of their own."""
        assert 0 <= lo <= hi <= self.shape[0], (lo, hi, self.shape)
        da = self._da
        if da.ndim == 1:
            out = np.array(
                da._mmap_block(_fs._block_fname((self._i,)))[lo:hi])
        else:
            cols = [np.array(
                da._mmap_block(_fs._block_fname((self._i, j)))[lo:hi])
                for j in range(da.grid.grid_shape[1])]
            out = cols[0] if len(cols) == 1 else np.concatenate(cols, 1)
        PANEL_BYTES_READ["bytes"] += out.nbytes
        return out


class DiskArray:
    """A 1-D or 2-D array resident on disk as grid blocks: an immutable
    view of a ``write_fs`` directory."""

    def __init__(self, path: str, fs, verify: bool = False):
        self._path = path
        self._fs = fs
        meta = fs.read_meta_fs(path)
        self.grid = ArrayGrid.from_meta(meta["grid"])
        assert len(self.grid.shape) in (1, 2), (
            "DiskArray supports 1-D/2-D arrays", self.grid.shape
        )
        # read_fs's resilience: a primary block that does not load fails
        # over to the replicas, CRC-guarded; verify=True CRC-checks the
        # primaries on every read too.
        self._checks = meta.get("checksums")
        self._verify = bool(verify)

    def _mmap_block(self, fname: str) -> np.ndarray:
        """A memory-mapped view of one primary block (a row range reads
        only its pages), or the checked full load when the primary does
        not open. The multi-process panel reads of the mesh port read
        their rows through it."""
        if not self._verify:
            try:
                return np.load(os.path.join(self._path, fname),
                               mmap_mode="r")
            except Exception:
                pass
        return self._load_block(fname)

    def _load_block(self, fname: str) -> np.ndarray:
        primary = os.path.join(self._path, fname)
        if not self._verify:
            try:
                return np.load(primary)
            except Exception:
                pass  # fail over (CRC-guarded) to the replicas
        return _fs.FileSystem._load_block_checked(
            primary, _fs._existing_replicas(self._path), self._checks
        )

    @property
    def path(self):
        return self._path

    @property
    def backend(self):
        """The backend that streamed panels are placed on."""
        return self._fs.backend

    @property
    def shape(self):
        return self.grid.shape

    @property
    def dtype(self):
        return np.dtype(self.grid.dtype)

    @property
    def ndim(self):
        return len(self.grid.shape)

    @property
    def nbytes(self):
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def row_panel(self, i: int) -> np.ndarray:
        """Row stripe i, assembled across the column blocks in host
        memory."""
        if self.ndim == 1:
            return self._load_block(_fs._block_fname((i,)))
        cols = [
            self._load_block(_fs._block_fname((i, j)))
            for j in range(self.grid.grid_shape[1])
        ]
        return cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)

    @property
    def num_row_panels(self):
        return self.grid.grid_shape[0]

    def iter_row_panels(self, prefetch: bool = True):
        """Yield (start_row, panel) host arrays in row order. With
        ``prefetch`` the next panel loads on a worker thread while the
        caller works on the current one (NumPy's file reads release the
        GIL)."""
        n_panels = self.num_row_panels
        starts = [s for s, _ in self.grid.grid_slices[0]]
        if not prefetch or n_panels <= 1:
            for i in range(n_panels):
                yield starts[i], self.row_panel(i)
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self.row_panel, 0)
            for i in range(n_panels):
                panel = fut.result()
                if i + 1 < n_panels:
                    fut = ex.submit(self.row_panel, i + 1)
                yield starts[i], panel

    def iter_panel_refs(self):
        """Yield (start_row, PanelRef) in row order: ``iter_row_panels``
        without reading, so that each process loads only its own rows."""
        for i, (start, stop) in enumerate(self.grid.grid_slices[0]):
            yield start, PanelRef(self, i, stop - start)

    @classmethod
    def from_panels(cls, path: str, fs, panels, shape, dtype,
                    block_rows: int):
        """Write a DiskArray from a stream of host row panels.

        The panels' rows concatenate to ``shape``; each panel spans whole
        row blocks of ``block_rows`` rows (the last block ragged). The
        publish is ``write_fs``'s: a tmp directory, CRCs, ``meta.pkl``
        last and fsynced, and a rename that keeps an earlier version as an
        ``.old-`` backup until the new one is in place. Host memory holds
        one panel.

        Collective under several processes: every process iterates the
        same stream in step (a producer may hold collectives, as the
        streamed predictions' gathers); process 0 alone writes to the
        shared filesystem, and the others open the result after its
        release barrier (``multiprocess.publishing``)."""
        from nums_tpu_torch.core import multiprocess as _mp

        path = _fs._fs_path(path)
        if not _mp.is_multiprocess():
            return cls._write_panels_p0(path, fs, panels, shape, dtype,
                                        block_rows)
        tag = f"DiskArray.from_panels:{path}"
        marker = f"{path}.ingest-failed"
        what = f"DiskArray.from_panels({path!r})"
        if _mp.process_index() != 0:
            try:
                for _ in panels:  # in step with process 0's collectives
                    pass
            except BaseException:
                # Release process 0 first (it waits at the barrier),
                # then raise this process's own failure.
                _mp.barrier(tag)
                raise
            _mp.await_published(tag, marker, what)
            return cls(path, fs)
        with _mp.publishing(tag, marker):
            try:
                return cls._write_panels_p0(path, fs, panels, shape, dtype,
                                            block_rows)
            except BaseException:
                # A failed write leaves the stream midway: drain it, so
                # that a producer's collectives stay matched with the
                # peers'. A producer that raised is closed already.
                try:
                    for _ in panels:
                        pass
                except BaseException:  # noqa: BLE001 - keep the first
                    pass
                raise

    @classmethod
    def _write_panels_p0(cls, path, fs, panels, shape, dtype, block_rows):
        shape = tuple(int(s) for s in shape)
        assert len(shape) in (1, 2), shape
        block_shape = (
            (block_rows,) if len(shape) == 1 else (block_rows, shape[1])
        )
        grid = ArrayGrid(shape, block_shape, np.dtype(dtype).name)
        tmp = f"{path}.tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        checksums = {}
        row = 0
        block_i = 0
        for panel in panels:
            panel = np.asarray(panel, dtype=dtype)
            assert panel.shape[1:] == shape[1:], (panel.shape, shape)
            off = 0
            while off < panel.shape[0]:
                blk = panel[off:off + block_rows]
                assert blk.shape[0] == min(
                    block_rows, shape[0] - row
                ), "panels must align to block_rows boundaries"
                entry = (block_i,) if len(shape) == 1 else (block_i, 0)
                fname = _fs._block_fname(entry)
                np.save(os.path.join(tmp, fname), blk)
                checksums[fname] = _fs._block_crc(blk)
                off += blk.shape[0]
                row += blk.shape[0]
                block_i += 1
        assert row == shape[0], (row, shape)
        _fs._write_meta(tmp, {"grid": grid.to_meta(),
                              "checksums": checksums})
        if os.path.isdir(path):
            trash = f"{path}.old-{os.getpid()}"
            shutil.rmtree(trash, ignore_errors=True)
            os.rename(path, trash)
            os.rename(tmp, path)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, path)
        return cls(path, fs)

    def to_block_array(self, block_shape=None):
        """The whole array in device memory."""
        out = self._fs.read_fs(self._path)
        if block_shape is not None and tuple(block_shape) != out.block_shape:
            out = out.reshape(out.shape, block_shape=block_shape)
        return out

    def __repr__(self):
        return (
            f"DiskArray(shape={self.shape}, dtype={self.dtype.name}, "
            f"panels={self.num_row_panels}, path={self._path!r})"
        )
