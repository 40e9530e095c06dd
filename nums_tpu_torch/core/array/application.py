"""ArrayApplication: constructors, block-shape policy, array ops, I/O and
the out-of-core ops.

Counterpart of the subset of ``nums_tpu/core/array/application.py`` that
the GLMs and the out-of-core path use: the block-shape policy,
``scalar``/``array``/``zeros``/``ones``/``full``/``eye``/``diag``/
``empty``/``arange``/``linspace``/``concatenate``/``split``, the
elementwise ops and reductions (``reduce``, ``argmin``/``argmax``),
``matmul``/``tensordot``, ``allclose``, both forms of ``where``,
``var``/``std``, the linalg entry points
(``qr``, ``indirect_tsr``/``indirect_tsqr``, ``direct_tsqr``, ``svd``,
``randomized_svd``, the regressions, ``inv``/``cholesky``/
``posdef_solve``), ``get``/``touch``, the random state, the block checkpoints of the
application's ``FileSystem`` (``write_fs``/``read_fs``/``verify_fs``/
``delete_fs``), and the streamed ops on a ``DiskArray`` (``gram_ooc``, the
column reductions, ``tsqr_r_ooc``, ``linear_regression_ooc``), with the
panel helpers that the GLMs' out-of-core fits share (``ooc_put``,
``ooc_accumulator``, ``ooc_panels``, ``_ooc_y_getter``). On the mesh
backend the constructors place each array by the grid (a constant fill
makes only this process's region), and ``get`` is collective. Out of core
on the mesh, each panel is row-sharded over the whole mesh (``ooc_put``:
this process moves only its own rows, and under several processes reads
only those from disk); a fold runs on this process's rows of each panel
and ends the pass with one all-reduce over the mesh
(``streaming.reduce_rows``), its carry replicated.
"""

import functools

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess, settings
from nums_tpu_torch.core.backend import Backend
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array.diskarray import DiskArray
from nums_tpu_torch.core.array.random import NumsRandomState
from nums_tpu_torch.core.io.filesystem import FileSystem, _fs_path
from nums_tpu_torch.core.ops import (
    creation, elementwise, linalg, mesh_ops, shape_ops, streaming,
)


def _device_dtype(backend, dtype) -> torch.dtype:
    """``Backend.device_dtype`` as a torch dtype."""
    return array_utils.to_torch_dtype(backend.device_dtype(dtype))


def _device_rows(panel, lo, hi):
    """Host rows [lo, hi) of a panel: a host array's slice, or what a lazy
    ``PanelRef`` loads of them from disk (this process's rows alone)."""
    if hasattr(panel, "load"):
        return panel.load(lo, hi)
    return panel[lo:hi]


def _global_put(backend, get_rows, gshape, dtype):
    """A row-sharded DTensor of global shape ``gshape`` on the mesh: this
    process moves only the rows of its region, ``get_rows(lo, hi)``, to
    its device (``from_local``, no communication). The reference's
    ``_global_put``."""
    placements = streaming.row_placements(backend.mesh)
    (lo, hi) = backend.region(gshape, placements)[0]
    host = np.ascontiguousarray(get_rows(lo, hi))
    local = torch.from_numpy(host).to(backend.device).to(dtype)
    return backend.from_local(local, gshape, placements)


def ooc_put(backend, panel, augment_ones=False):
    """Host panel -> the backend's device. Returns (device panel, its row
    count); the device dtype is ``_device_dtype``'s.

    On the serial backend the panel moves whole. With ``augment_ones`` it
    moves as it is and the intercept-augmented (rows, d + 1) panel, ones
    in the last column, is built on the device, not in host memory.

    On the mesh backend it becomes a DTensor whose rows are sharded over
    the whole mesh (``streaming.row_placements``): each process moves only
    its own rows, and where ``panel`` is a lazy ``PanelRef`` (several
    processes: ``ooc_panels``), reads only those from disk. DTensor's
    uneven shards carry no pad rows, where the reference pads the panel to
    the device multiple and masks the pad. ``augment_ones`` is serial-only,
    as in the reference: a mesh fold augments its local rows
    (``streaming.augment_ones``)."""
    dtype = _device_dtype(backend, panel.dtype)
    rows = int(panel.shape[0])
    if backend.mesh is not None:
        if augment_ones:
            raise ValueError(
                "augment_ones is serial-backend only: augment this "
                "process's rows of the mesh panel (streaming.augment_ones)"
            )
        gshape = tuple(int(s) for s in panel.shape)
        return _global_put(backend, lambda lo, hi: _device_rows(
            panel, lo, hi), gshape, dtype), rows
    if hasattr(panel, "full"):
        panel = panel.full()
    host = torch.from_numpy(np.ascontiguousarray(panel))
    if not augment_ones:
        return host.to(backend.device).to(dtype), rows
    out = torch.empty((rows, int(panel.shape[1]) + 1), dtype=dtype,
                      device=backend.device)
    out[:, :-1].copy_(host)
    out[:, -1] = 1
    return out, rows


def ooc_accumulator(backend, value):
    """A fold's accumulator or carry: ``value`` (a host array or a tensor)
    on the backend's device. On the mesh it is replicated: each process
    holds the same whole value, and a fold's partial sums over this
    process's rows meet in the all-reduce that ends the pass."""
    return torch.as_tensor(value, device=backend.device)


def ooc_panels(X):
    """The row-panel stream of a fold: host panels, prefetched; under
    several processes lazy ``PanelRef``s, so that each process reads only
    its own rows."""
    from nums_tpu_torch.core import multiprocess

    if multiprocess.is_multiprocess():
        return X.iter_panel_refs()
    return X.iter_row_panels()


def gather_rows(backend, local, shape):
    """The whole (rows, ...) value on every process from this process's
    rows ``local`` of a row-sharded panel (``ooc_put``'s layout): an
    all-gather under several processes, ``local`` itself otherwise.
    Returns a host array."""
    from nums_tpu_torch.core import multiprocess

    if backend.mesh is None:
        return backend.get(local)
    dt = backend.from_local(local.contiguous(), tuple(shape),
                            streaming.row_placements(backend.mesh))
    return multiprocess.allgather_to_host(dt)


def _ooc_y_getter(X, y):
    """(start, length) -> the host slice of y aligned with X's row panels.

    y may be a 1-D DiskArray with X's row partitioning, a BlockArray
    (fetched to the host once, here), or a host array."""
    if isinstance(y, DiskArray):
        assert y.ndim == 1, y.shape
        assert list(y.grid.grid_slices[0]) == list(X.grid.grid_slices[0]), (
            "y DiskArray must share X's row partitioning"
        )
        index = {s: i for i, (s, _) in enumerate(y.grid.grid_slices[0])}
        from nums_tpu_torch.core import multiprocess

        if multiprocess.is_multiprocess():
            from nums_tpu_torch.core.array.diskarray import PanelRef

            # Lazy, as X's panels: ooc_put reads this process's rows.
            return lambda start, length: PanelRef(y, index[start], length)

        def get(start, length):
            arr = y.row_panel(index[start])
            assert arr.shape[0] == length, (arr.shape, length)
            return arr

        return get
    host = y.get() if isinstance(y, BlockArray) else np.asarray(y)
    if host.shape[:1] != (X.shape[0],):
        raise ValueError(
            f"y has {host.shape[0] if host.ndim else 'scalar'} rows, "
            f"X has {X.shape[0]} — an oversized y would be silently "
            f"truncated to X's row range"
        )

    def get(start, length):
        return host[start:start + length]

    return get


class ArrayApplication:
    def __init__(self, backend: Backend, filesystem: FileSystem):
        self.backend = backend
        # `system` alias preserves the reference attribute name.
        self.system = backend
        self.fs = filesystem
        self._block_shape_map = {}
        self._random = None
        self.one_half = self.scalar(0.5)
        self.two = self.scalar(2.0)
        self.one = self.scalar(1.0)
        self.zero = self.scalar(0.0)

    def num_cores_total(self):
        return self.backend.num_cores_total

    # ------------------------------------------------------------------
    # Block-shape policy (nums_tpu application.py:253-310)
    # ------------------------------------------------------------------

    def compute_block_shape(self, shape: tuple, dtype, cluster_shape=None,
                            num_cores=None):
        """Small arrays (< 100 MB) get a single block; otherwise the grid
        is sized to about the device count, weighted toward long axes and
        aligned to the mesh's ``cluster_shape``."""
        dtype = array_utils.to_np_dtype(dtype)
        size = int(np.prod(shape)) * dtype.itemsize if len(shape) else (
            dtype.itemsize
        )
        if size < 10**8:
            return tuple(shape)
        if num_cores is None:
            num_cores = self.num_cores_total()
        if cluster_shape is None:
            # On the mesh the grid aligns to the mesh (application.py:
            # 253-275 of the reference).
            cluster_shape = getattr(self.backend, "cluster_shape", (1, 1))
        if len(shape) < len(cluster_shape):
            cluster_shape = cluster_shape[: len(shape)]
        elif len(shape) > len(cluster_shape):
            cluster_shape = tuple(cluster_shape) + (1,) * (
                len(shape) - len(cluster_shape)
            )
        shape_np = np.array(shape, dtype=np.int64)
        cluster_weights = np.exp(np.array(cluster_shape)) / np.sum(
            np.exp(cluster_shape)
        )
        shape_fracs = shape_np / np.sum(shape_np)
        weighted = cluster_weights * shape_fracs
        weighted = weighted / np.sum(weighted)
        grid_shape_frac = num_cores**weighted
        grid_shape = np.floor(grid_shape_frac)
        remaining = np.sum(grid_shape_frac - grid_shape)
        grid_shape[np.argmax(shape_np)] += remaining
        grid_shape = np.ceil(grid_shape).astype(np.int64)
        return tuple(
            int(x) for x in (shape_np + grid_shape - 1) // grid_shape
        )

    def get_block_shape(self, shape, dtype):
        """Memoized per-dimension block sizes."""
        block_shape = self.compute_block_shape(shape, dtype)
        final = []
        for axis in range(len(shape)):
            dim = shape[axis]
            if dim not in self._block_shape_map:
                self._block_shape_map[dim] = block_shape[axis]
            final.append(self._block_shape_map[dim])
        return tuple(final)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    def scalar(self, value):
        return BlockArray.from_scalar(value, self.backend)

    def array(self, array, block_shape: tuple = None):
        array = np.asarray(array)
        if block_shape is None:
            block_shape = self.get_block_shape(array.shape, array.dtype)
        assert len(array.shape) == len(block_shape)
        return BlockArray.from_np(array, block_shape=block_shape,
                                  backend=self.backend)

    def _new_array(self, op_name, shape, block_shape, dtype=None):
        if dtype is None:
            dtype = self.backend.default_float
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        return self._filled(grid, lambda shape: creation.new_array(
            op_name, shape, array_utils.to_torch_dtype(dtype),
            self.backend.device))

    def _filled(self, grid, make):
        """A constant fill: ``make(shape)`` of this process's region only
        (the whole array on one device)."""
        box = self.backend.local_region(grid)
        if box is None:
            return BlockArray(make(grid.shape), grid, self.backend)
        local = make(tuple(b - a for a, b in box))
        data = self.backend.from_local(local, grid.shape,
                                       self.backend.sharding_for_grid(grid))
        return BlockArray(data, grid, self.backend)

    def zeros(self, shape, block_shape, dtype=None):
        return self._new_array("zeros", shape, block_shape, dtype)

    def ones(self, shape, block_shape, dtype=None):
        return self._new_array("ones", shape, block_shape, dtype)

    def empty(self, shape, block_shape, dtype=None):
        return self._new_array("empty", shape, block_shape, dtype)

    def full(self, shape, block_shape, fill_value, dtype=None):
        if dtype is None:
            dtype = np.asarray(fill_value).dtype
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        return self._filled(grid, lambda shape: creation.full(
            shape, fill_value, array_utils.to_torch_dtype(dtype),
            self.backend.device))

    def eye(self, shape, block_shape, dtype=None):
        assert len(shape) == len(block_shape) == 2
        return self.eye_k(shape, block_shape, k=0, dtype=dtype)

    def eye_k(self, shape, block_shape, k=0, dtype=None):
        if dtype is None:
            dtype = self.backend.default_float
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        data = creation.eye(grid.shape, array_utils.to_torch_dtype(dtype),
                            self.backend.device, int(k))
        return BlockArray(data, grid, self.backend)

    def diag(self, X: BlockArray) -> BlockArray:
        if X.ndim == 1:
            block_shape = (X.block_shape[0], X.block_shape[0])
            from nums_tpu_torch.core.ops import mesh_ops

            if self._sharded(X):
                # each process writes its own box from the vector's
                # elements that fall there (one all-to-all)
                n = X.shape[0]
                grid = ArrayGrid((n, n), block_shape, X.dtype.name)
                return BlockArray(mesh_ops.diagonal_matrix(
                    self.backend, X.data, 0, (n, n),
                    self.backend.sharding_for_grid(grid)), grid,
                    self.backend)
            if mesh_ops.is_dtensor(X.data):
                # a replicated vector: each process's own copy
                out = creation.diag(X.data.to_local())
                return BlockArray.from_torch(
                    mesh_ops.like(X.data, out, tuple(out.shape)),
                    block_shape, self.backend)
        elif X.ndim == 2:
            assert X.shape[0] == X.shape[1], "X must be square."
            block_shape = (X.block_shape[0],)
        else:
            raise ValueError("X must have 1 or 2 axes.")
        return BlockArray.from_torch(creation.diag(X.data), block_shape,
                                     self.backend)

    def arange(self, shape, block_shape, step=1, dtype=None) -> BlockArray:
        if dtype is None:
            dtype = np.int64
        assert step == 1
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        data = creation.arange(0, grid.shape[0], step,
                               array_utils.to_torch_dtype(dtype),
                               self.backend.device)
        return BlockArray(data, grid, self.backend)

    def linspace(self, start, stop, shape, block_shape, endpoint=True,
                 retstep=False, dtype=None, axis=0):
        assert axis == 0 and retstep is False
        dtype = _device_dtype(self.backend, dtype if dtype else np.float64)
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        data = creation.linspace(start, stop, grid.shape[0], bool(endpoint),
                                 dtype, self.backend.device)
        return BlockArray(data, grid, self.backend)

    def concatenate(self, arrays, axis, axis_block_size=None):
        if len(arrays) == 1:
            return arrays[0]
        first = arrays[0]
        for a in arrays:
            assert a.ndim == first.ndim, "Unequal num axes."
        axis = int(axis) % first.ndim
        lshape = list(first.shape)
        lshape[axis] = sum(a.shape[axis] for a in arrays)
        lshape = tuple(lshape)
        result_block_shape = list(first.block_shape)
        result_block_shape[axis] = (
            axis_block_size if axis_block_size is not None
            else first.block_shape[axis]
        )
        result_block_shape = tuple(
            min(b, s) for b, s in zip(result_block_shape, lshape)
        )
        tensors = [a.data for a in arrays]
        if self.backend.mesh is not None:
            # each operand's rows go to their place in the result's layout
            # (one all-to-all along a sharded axis): never a whole copy
            from nums_tpu_torch.core.ops import mesh_ops

            dt = tensors[0].dtype
            for t in tensors[1:]:
                dt = torch.promote_types(dt, t.dtype)
            tensors = [t.to(dt) for t in tensors]
            grid = ArrayGrid(lshape, result_block_shape,
                             array_utils.to_dtype_name(tensors[0].dtype))
            data = mesh_ops.concat(self.backend, tensors, axis,
                                   self.backend.sharding_for_grid(grid))
        else:
            data = shape_ops.concatenate(tensors, axis)
        return BlockArray(
            data, ArrayGrid(lshape, result_block_shape,
                            array_utils.to_dtype_name(data.dtype)),
            self.backend,
        )

    def split(self, X: BlockArray, indices_or_sections, axis=0):
        if not isinstance(indices_or_sections, int):
            raise NotImplementedError("Split currently supports integers only.")
        dim = X.shape[axis]
        assert dim % indices_or_sections == 0, (
            "array split does not result in an equal division"
        )
        step = dim // indices_or_sections
        out = []
        for i in range(indices_or_sections):
            sel = tuple(
                slice(i * step, (i + 1) * step) if ax == axis else slice(None)
                for ax in range(X.ndim)
            )
            out.append(X[sel])
        return out

    # ------------------------------------------------------------------
    # Elementwise / reductions
    # ------------------------------------------------------------------

    def map_uop(self, op_name, arr, out=None, where=True, args=None,
                kwargs=None):
        if where is not True or out is not None:
            raise NotImplementedError("'out' and 'where' are not supported.")
        del args, kwargs
        return arr.ufunc(op_name)

    def map_bop(self, op_name, arr_1, arr_2, out=None, where=True,
                args=None, kwargs=None):
        if where is not True or out is not None:
            raise NotImplementedError("'out' and 'where' are not supported.")
        del args, kwargs
        if not isinstance(arr_1, BlockArray):
            arr_2_ba = (arr_2 if isinstance(arr_2, BlockArray)
                        else self.scalar(arr_2))
            return arr_2_ba._bop(op_name, arr_1, reverse=True)
        return arr_1._bop(op_name, arr_2)

    def log(self, X):
        return self.map_uop("log", X)

    def exp(self, X):
        return X.ufunc("exp")

    def abs(self, X):
        return self.map_uop("abs", X)

    def sqrt(self, X):
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        return X.ufunc("sqrt")

    def norm(self, X):
        return self.sqrt(X.T @ X)

    def xlogy(self, x: BlockArray, y) -> BlockArray:
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        return self.map_bop("xlogy", x, y)

    def min(self, X, axis=None, keepdims=False):
        return self.reduce("min", X, axis, keepdims)

    def max(self, X, axis=None, keepdims=False):
        return self.reduce("max", X, axis, keepdims)

    def sum(self, X, axis=None, keepdims=False, dtype=None):
        return self.reduce("sum", X, axis, keepdims, dtype)

    def reduce(self, op_name, X, axis=None, keepdims=False, dtype=None):
        # dtype is the accumulator dtype (see ops/reductions.py), not a
        # cast of the result.
        return X.reduce_axis(op_name, axis, keepdims=keepdims, dtype=dtype)

    def mean(self, X, axis=None, keepdims=False, dtype=None):
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(self.backend.default_float)
        return X.mean(axis=axis, keepdims=keepdims, dtype=dtype)

    def var(self, X, axis=None, ddof=0, keepdims=False, dtype=None):
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        return X.var(axis=axis, ddof=ddof, keepdims=keepdims, dtype=dtype)

    def std(self, X, axis=None, ddof=0, keepdims=False, dtype=None):
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        return X.std(axis=axis, ddof=ddof, keepdims=keepdims, dtype=dtype)

    def argmin(self, X, axis=None):
        return self.argop("argmin", X, axis)

    def argmax(self, X, axis=None):
        return self.argop("argmax", X, axis)

    def argop(self, op_name, arr, axis=None):
        """The reference keeps its one-dimensional restriction; so does
        this."""
        if arr.ndim > 1:
            raise NotImplementedError(
                f"{op_name} currently supports one-dimensional arrays."
            )
        if axis is None:
            axis = 0
        assert axis == 0
        return getattr(arr, op_name)(axis=None).astype(np.int64)

    def where(self, condition: BlockArray, x=None, y=None):
        """``where(c, x, y)``: elementwise select, with the two branches
        promoted as a binary op promotes them. ``where(c)``: one int64
        index array per axis (``numpy.where``'s order), resolved on the
        device by ``torch.nonzero`` (one host sync, for the count); on the
        mesh each process's rows, re-placed (``mesh_ops.where``)."""
        if x is None and y is None:
            if self.backend.mesh is not None and condition.ndim:
                index_arrays = mesh_ops.where(self.backend, condition.data)
                count = int(index_arrays[0].shape[0])
                bs = ((condition.mesh_rows_block(
                    count, condition.grid.num_blocks),) if count else (0,))
                return tuple(BlockArray.from_torch(arr, bs, self.backend)
                             for arr in index_arrays)
            if self.backend.mesh is not None:
                host = np.where(condition.get())
                return tuple(self.array(a, block_shape=a.shape)
                             for a in host)
            index_arrays = torch.nonzero(condition.data.to(torch.bool),
                                         as_tuple=True)
            result = []
            for arr in index_arrays:
                count = int(arr.shape[0])
                bs = (self.compute_block_shape((count,), np.int64)
                      if count else (0,))
                result.append(BlockArray.from_torch(arr, bs, self.backend))
            return tuple(result)
        assert x is not None and y is not None
        x = condition.check_or_convert_other(x)
        y = condition.check_or_convert_other(y)
        xd = x.data if isinstance(x, BlockArray) else x
        yd = y.data if isinstance(y, BlockArray) else y
        if not (torch.is_tensor(xd) or torch.is_tensor(yd)):
            xd = torch.as_tensor(np.asarray(xd), device=self.backend.device)
            if xd.is_floating_point():
                xd = xd.to(array_utils.to_torch_dtype(
                    self.backend.default_float))
        xd, yd = elementwise.promote(
            xd, yd, array_utils.to_torch_dtype(self.backend.default_float)
        )
        data = shape_ops.where3(condition.data, xd, yd)
        lshape = tuple(data.shape)
        return BlockArray(
            data,
            ArrayGrid(lshape, array_utils.default_block_shape_for(
                lshape, condition.block_shape),
                array_utils.to_dtype_name(data.dtype)),
            self.backend,
        )

    # ------------------------------------------------------------------
    # Linalg (nums_tpu application.py:665-882). The ops of
    # ``core/ops/linalg.py`` run in plain float32 (TF32 off) in every
    # precision setting; the BlockArray products here (``X @ R_inv``,
    # ``R.T @ R``, ``X.T @ y``) follow ``settings.matmul_precision``, and
    # of those the same-tensor gram ``R.T @ R`` of ``ridge_regression``
    # goes to the gram kernel in the bf16 class.
    # ------------------------------------------------------------------

    def qr(self, X: BlockArray):
        return self.indirect_tsqr(X)

    def _tsqr_chunk(self, X):
        return linalg.choose_chunk(X.shape[0], X.shape[1])

    def _cholqr_rows(self, X, fn, *others):
        """``fn(x, *others, reduce)`` of a CholeskyQR route. On the mesh
        (X a DTensor) ``x`` is this process's rows of X, every column
        (``others`` likewise, by X's rows), and ``reduce`` sums a gram over
        the processes that hold other rows: one all-reduce of n×n, never
        X whole (DTensor has no strategy for the factor). Returns
        (``fn``'s result, the rows' placements, or None off the mesh)."""
        from nums_tpu_torch.core.ops import mesh_ops, summa

        data = X.data
        if not mesh_ops.is_dtensor(data):
            return fn(data, *[o.data for o in others]), None
        rows = summa.row_layout(data)
        lead = mesh_ops.rows_only(rows)
        parts = [summa.local_part(o.data, lead) for o in others]
        return fn(summa.local_part(data, rows), *parts,
                  reduce=lambda t: summa.all_reduce_rows(
                      data.device_mesh, rows, t)), lead

    def _rows_of(self, X, local, lead):
        """A result of this process's rows of X as a DTensor of X's rows
        (``local`` itself off the mesh)."""
        if lead is None:
            return local
        return self.backend.from_local(
            local.contiguous(), (X.shape[0],) + tuple(local.shape[1:]),
            lead)

    @staticmethod
    def _sharded(X) -> bool:
        """Whether X's tensor is a DTensor that the mesh shards (the
        Householder tree then runs on each process's rows,
        ``mesh_linalg.householder_qr``)."""
        from nums_tpu_torch.core.ops import mesh_ops

        return mesh_ops.is_dtensor(X.data) and any(
            p.is_shard() for p in X.data.placements)

    def _use_cholqr(self, X=None) -> bool:
        """CholeskyQR2 or the Householder tree. CholeskyQR needs full
        column rank, so a wide matrix takes Householder everywhere; under
        ``settings.tsqr_method == "auto"`` the backend's device decides:
        CholeskyQR2 (GEMMs and triangular solves) on ``cuda``, Householder
        on ``cpu``."""
        if X is not None and X.shape[0] < X.shape[1]:
            return False
        method = settings.tsqr_method
        if method == "cholqr2":
            return True
        if method == "householder":
            return False
        return self.backend.device.type == "cuda"

    def _wrap(self, data, block_shape):
        return BlockArray.from_torch(data, block_shape, self.backend)

    def indirect_tsr(self, X: BlockArray, reshape_output=True) -> BlockArray:
        """The R factor of X, by CholeskyQR (``linalg.cholqr_r``) or the
        TSQR reduction tree."""
        assert X.ndim == 2
        del reshape_output
        if self._use_cholqr(X):
            r, _ = self._cholqr_rows(X, linalg.cholqr_r)
        elif self._sharded(X):
            from nums_tpu_torch.core.ops import mesh_linalg

            _, r = mesh_linalg.householder_qr(self.backend, X.data,
                                              self._tsqr_chunk(X), False)
        else:
            r = linalg._tsqr_r_impl(X.data, self._tsqr_chunk(X))
        return self._wrap(
            r, (min(X.block_shape[1], r.shape[0]), X.block_shape[1]))

    def indirect_tsqr(self, X: BlockArray, reshape_output=True):
        """(Q, R) with Q = X R⁻¹."""
        R = self.indirect_tsr(X, reshape_output)
        return X @ self.inv(R), R

    def direct_tsqr(self, X: BlockArray, reshape_output=True,
                    overwrite_x=False):
        """(Q, R) by CholeskyQR2 or the recursive Householder tree.

        ``overwrite_x=True`` takes the streamed CholeskyQR2 that writes Q
        into X's own tensor: peak device memory about 1× X where the other
        routes hold 3×. X is destroyed: it shares Q's storage afterwards
        (the reference donates X's buffer and repoints X the same way).
        ``overwrite_x`` always takes CholeskyQR2, whatever
        ``settings.tsqr_method`` says, as the reference's does: X must be
        tall (m >= n) and of full rank, or Q and R are NaN."""
        assert X.ndim == 2
        del reshape_output
        if overwrite_x:
            q, r = linalg.cholqr2_stream(2**20, X.data)
        elif self._use_cholqr(X):
            (q, r), lead = self._cholqr_rows(X, linalg.cholqr2)
            q = self._rows_of(X, q, lead)
        elif self._sharded(X):
            from nums_tpu_torch.core.ops import mesh_linalg

            q, r = mesh_linalg.householder_qr(self.backend, X.data,
                                              self._tsqr_chunk(X))
        else:
            q, r = linalg.direct_tsqr(self._tsqr_chunk(X), X.data)
        Q = self._wrap(q, (X.block_shape[0],
                           min(X.block_shape[1], q.shape[1])))
        R = self._wrap(r, (min(X.block_shape[1], r.shape[0]),
                           X.block_shape[1]))
        return Q, R

    def pinv(self, X: BlockArray) -> BlockArray:
        """The pseudo-inverse of a tall row-sharded X on the mesh: X = QR
        by the TSQR route ``svd`` takes (CholeskyQR2 or the Householder
        tree), then pinv(X) = pinv(R)·Qᵀ. Each process's rows of Q times
        pinv(R)ᵀ are its rows of pinv(X)ᵀ, so the result is the lazy
        transpose of an (m, n) array laid out as X's rows: no process
        holds X or the result whole."""
        m, n = X.shape
        if self._use_cholqr(X):
            (q, r), lead = self._cholqr_rows(X, linalg.cholqr2)
        else:
            from nums_tpu_torch.core.ops import mesh_linalg

            q, r = mesh_linalg.householder_qr(self.backend, X.data,
                                              self._tsqr_chunk(X))
            lead = tuple(q.placements)
            q = q.to_local()
        # the small pseudo-inverse in float64, as the small SVDs; Q's rows
        # times its transpose written over Q (no second (m, n) tensor)
        pr = torch.linalg.pinv(r.to(torch.float64)).to(q.dtype)
        q = linalg._inplace_right_mul(q.contiguous(), pr.T.contiguous(),
                                      1 << 20)
        raw = self.backend.from_local(q, (m, n), lead)
        grid = ArrayGrid((n, m), (n, X.block_shape[0]),
                         array_utils.to_dtype_name(raw.dtype))
        return BlockArray(raw, grid, self.backend, transposed=True)

    def svd(self, X: BlockArray, k=None, overwrite_x=False):
        """Tall-skinny SVD (U, S, Vᵀ) through TSQR, U with only its first
        ``k`` columns (all: None). With ``overwrite_x`` the CholeskyQR2
        route writes Q into X's own tensor (X is destroyed; device memory
        then holds X, one chunk of the solve and U)."""
        assert X.ndim == 2
        if self._use_cholqr(X):
            (u, s, vt), lead = self._cholqr_rows(X, functools.partial(
                linalg.svd_cholqr, k=k, overwrite=overwrite_x))
            u = self._rows_of(X, u, lead)
        elif self._sharded(X):
            from nums_tpu_torch.core.ops import mesh_linalg

            q, r = mesh_linalg.householder_qr(self.backend, X.data,
                                              self._tsqr_chunk(X))
            u_r, s, vt = linalg._small_svd(r)
            u_r = u_r if k is None else u_r[:, :k]
            u = self.backend.from_local(
                (q.to_local() @ u_r).contiguous(),
                (X.shape[0], int(u_r.shape[1])), tuple(q.placements))
        else:
            u, s, vt = linalg.svd(self._tsqr_chunk(X), X.data)
            u = u if k is None else u[:, :k].contiguous()
        nb = min(X.block_shape[1], X.shape[1])
        return (
            self._wrap(u, (X.block_shape[0],
                           min(X.block_shape[1], u.shape[1]))),
            self._wrap(s, (nb,)),
            self._wrap(vt, (nb, nb)),
        )

    def randomized_svd(self, X: BlockArray, k: int, n_oversamples: int = 10,
                       n_iter: int = 2, seed: int = 0):
        """Randomized top-k SVD (Halko, Martinsson, Tropp 2011, Alg. 4.4 and
        5.1), for matrices whose both dimensions are large: a Gaussian
        sketch of width ell = k + ``n_oversamples``, ``n_iter`` power
        iterations re-orthonormalized by TSQR, then the exact SVD of the
        (ell, n) projection. No step holds more than max(m, n)·ell beside X.

        Deterministic for a given seed. The sketch is
        ``random_state(seed).normal``, on the reference's threefry
        counters: the same seed draws the reference's sketch (to the
        rounding of ``erfinv``), so the two packages agree draw for draw,
        not merely as far as the method is accurate."""
        assert X.ndim == 2
        m, n = X.shape
        k = int(k)
        assert 1 <= k <= min(m, n)
        ell = min(k + int(n_oversamples), min(m, n))
        omega = self.random_state(seed).normal(
            shape=(n, ell), block_shape=(min(X.block_shape[1], n), ell),
            dtype=X.dtype,
        )
        u, s, vt = linalg.randomized_svd(
            k, int(n_iter), self._tsqr_chunk(X), X.data, omega.data)
        return (
            self._wrap(u, (X.block_shape[0], k)),
            self._wrap(s, (k,)),
            self._wrap(vt, (k, min(X.block_shape[1], n))),
        )

    def fast_linear_regression(self, X: BlockArray, y: BlockArray):
        """Least squares through indirect TSQR: R⁻¹ (Qᵀ y)."""
        assert X.ndim == 2 and y.ndim == 1
        Q, R = self.indirect_tsqr(X)
        return self.inv(R) @ (Q.T @ y)

    def linear_regression(self, X: BlockArray, y: BlockArray):
        """Least squares through direct TSQR and a triangular solve."""
        assert X.ndim == 2 and y.ndim == 1
        if self._use_cholqr(X):
            theta, _ = self._cholqr_rows(X, linalg.lstsq_cholqr, y)
        else:
            theta = linalg.lstsq(self._tsqr_chunk(X), X.data, y.data)
        return self._wrap(theta, (min(X.block_shape[1], theta.shape[0]),))

    def lstsq(self, X: BlockArray, y: BlockArray):
        return self.linear_regression(X, y)

    def ridge_regression(self, X: BlockArray, y: BlockArray, lamb: float):
        """(λI + RᵀR)⁻¹ Xᵀy with R of ``indirect_tsr``; ``R.T @ R`` is the
        same-tensor gram, on the gram kernel in the bf16 class."""
        assert X.ndim == 2 and y.ndim == 1 and lamb >= 0
        R = self.indirect_tsr(X)
        n = R.shape[0]
        lamb_eye = self.eye_k(
            (n, n), (R.block_shape[0], R.block_shape[0]), dtype=X.dtype
        ) * lamb
        return self.inv(lamb_eye + R.T @ R) @ (X.T @ y)

    def _whole(self, X: BlockArray):
        """X's tensor whole on this process, or None for a sharded operand
        on the mesh (``core/ops/mesh_linalg.py`` takes it; it is never
        gathered to every process). On the mesh the small factorizations
        of a replicated value run on each process's copy, as XLA keeps it
        replicated; the result, the same everywhere, is placed by its
        grid."""
        if self.backend.mesh is None:
            return X.data
        from nums_tpu_torch.core.ops import mesh_ops

        data = X.data
        return None if mesh_ops._is_sharded(data) else data.to_local()

    def _placed(self, X: BlockArray, result):
        """A row-laid result of ``mesh_linalg`` as a BlockArray of X's
        grid (one all-to-all to the grid's layout; never a gather)."""
        return BlockArray(self.backend.rebox(
            result, self.backend.sharding_for_grid(X.grid)),
            X.grid.copy(), self.backend)

    def inv(self, X: BlockArray) -> BlockArray:
        assert X.ndim == 2 and X.shape[0] == X.shape[1]
        whole = self._whole(X)
        if whole is None:
            from nums_tpu_torch.core.ops import mesh_linalg

            return self._placed(X, mesh_linalg.inv(
                self.backend, X.data, X.block_shape[0]))
        return BlockArray(linalg.inv(whole), X.grid.copy(), self.backend)

    def cholesky(self, X: BlockArray) -> BlockArray:
        assert X.ndim == 2 and X.shape[0] == X.shape[1]
        whole = self._whole(X)
        if whole is None:
            from nums_tpu_torch.core.ops import mesh_linalg

            return self._placed(X, mesh_linalg.cholesky(
                self.backend, X.data, X.block_shape[0]))
        return BlockArray(linalg.cholesky(whole), X.grid.copy(),
                          self.backend)

    def posdef_solve(self, A: BlockArray, b: BlockArray) -> BlockArray:
        """Cholesky solve of A·x = b, the eager Newton-type solvers' step;
        NaN when A is not positive definite, with no host sync. A sharded
        A on the mesh takes ``mesh_linalg.posdef_solve`` (whose Cholesky
        raises where A is not positive definite)."""
        wa, wb = self._whole(A), self._whole(b)
        if wa is None:
            from nums_tpu_torch.core.ops import mesh_linalg

            data = mesh_linalg.posdef_solve(
                self.backend, A.data, b.data if wb is None else wb,
                A.block_shape[0])
        else:
            if wb is None:
                wb = multiprocess.sent_gather(b.data).full_tensor()
            data = linalg.posdef_solve(wa, wb)
        lshape = tuple(data.shape)
        return BlockArray(
            data,
            ArrayGrid(lshape, array_utils.default_block_shape_for(
                lshape, b.block_shape), array_utils.to_dtype_name(data.dtype)),
            self.backend,
        )

    def matmul(self, arr_1, arr_2):
        return arr_1 @ arr_2

    def tensordot(self, arr_1, arr_2, axes=2):
        return arr_1.tensordot(arr_2, axes)

    def allclose(self, a: BlockArray, b: BlockArray, rtol=1.0e-5,
                 atol=1.0e-8):
        """A 0-d boolean array: ``|a - b| <= atol + rtol * |b|``
        everywhere (NaNs unequal)."""
        assert a.shape == b.shape
        data = elementwise.allclose(
            a.data, b.data, rtol, atol,
            array_utils.to_torch_dtype(self.backend.default_float))
        return BlockArray.from_torch(data, (), self.backend)

    def get(self, *arrs):
        if len(arrs) == 1:
            a = arrs[0]
            return a.get() if isinstance(a, BlockArray) else a
        return [a.get() if isinstance(a, BlockArray) else a for a in arrs]

    def touch(self, *arrs):
        for a in arrs:
            a.touch()
        return arrs[0] if len(arrs) == 1 else arrs

    # ------------------------------------------------------------------
    # I/O (nums_tpu application.py:889-896, 1050-1089): the FileSystem's
    # block checkpoints, S3 objects and text ingestion
    # ------------------------------------------------------------------

    def write_fs(self, ba: BlockArray, filename: str, replicas: int = None):
        return self.fs.write_fs(ba, filename, replicas=replicas)

    def read_fs(self, filename: str, verify: bool = False) -> BlockArray:
        return self.fs.read_fs(filename, verify=verify)

    def verify_fs(self, filename: str, repair: bool = False) -> dict:
        return self.fs.verify_fs(filename, repair=repair)

    def delete_fs(self, filename: str):
        return self.fs.delete_fs(filename)

    def write_s3(self, ba: BlockArray, filename: str):
        return self.fs.write_s3(ba, filename)

    def read_s3(self, filename: str) -> BlockArray:
        return self.fs.read_s3(filename)

    def delete_s3(self, filename: str):
        return self.fs.delete_s3(filename)

    def _default_blocks(self, arr: BlockArray) -> BlockArray:
        """``arr`` in the block shape ``get_block_shape`` gives its shape."""
        block_shape = self.get_block_shape(arr.shape, arr.dtype)
        if block_shape != arr.block_shape:
            arr = arr.reshape(block_shape=block_shape)
        return arr

    def read_csv(
        self, filename, dtype=float, delimiter=",", has_header=False,
        num_workers=None,
    ):
        return self._default_blocks(self.fs.read_csv(
            filename, dtype=dtype, delimiter=delimiter, has_header=has_header,
            num_workers=num_workers,
        ))

    def loadtxt(
        self, fname, dtype=float, comments="# ", delimiter=" ",
        converters=None, skiprows=0, usecols=None, unpack=False, ndmin=0,
        encoding="bytes", max_rows=None, num_workers=None,
    ) -> BlockArray:
        return self._default_blocks(self.fs.loadtxt(
            fname, dtype=dtype, comments=comments, delimiter=delimiter,
            converters=converters, skiprows=skiprows, usecols=usecols,
            unpack=unpack, ndmin=ndmin, encoding=encoding, max_rows=max_rows,
            num_workers=num_workers,
        ))

    # ------------------------------------------------------------------
    # Out-of-core (DiskArray) ops (nums_tpu application.py:904-1048): one
    # streamed pass each, device memory one panel and the accumulator
    # ------------------------------------------------------------------

    def open_fs(self, filename: str, verify: bool = False) -> DiskArray:
        """An existing ``write_fs`` checkpoint as a DiskArray;
        ``verify=True`` CRC-checks every block on every panel read."""
        return DiskArray(_fs_path(filename), self.fs, verify=verify)

    def spill(self, ba: BlockArray, filename: str, replicas: int = None):
        """Write ``ba`` to disk and return the DiskArray view."""
        self.write_fs(ba, filename, replicas=replicas)
        return self.open_fs(filename)

    def _ooc_accumulate(self, X, init, update, op="sum"):
        """Fold ``update(acc, this process's rows of the device panel)``
        over X's row panels (a process with no rows of a panel skips it:
        the accumulator's identity stays), then, on the mesh, one
        all-reduce ``op`` over the mesh (None: the caller combines)."""
        acc = ooc_accumulator(self.backend, init)
        for _, panel in ooc_panels(X):
            p, _ = ooc_put(self.backend, panel)
            x = streaming.local_rows(p)
            if x.shape[0]:
                acc = update(acc, x)
        if op is not None:
            streaming.reduce_rows(self.backend.mesh, [acc], op)
        return acc

    def gram_ooc(self, X, dtype=None) -> BlockArray:
        """XᵀX of a DiskArray in one streamed pass; each panel's product
        rides the gram kernel where ``streaming._sym_gram`` takes it (on
        the mesh, on each process's rows, then one all-reduce)."""
        assert X.ndim == 2
        d = X.shape[1]
        dt = _device_dtype(self.backend, dtype or X.dtype)
        G = self._ooc_accumulate(
            X, torch.zeros((d, d), dtype=dt),
            lambda acc, p: streaming.gram_update(acc, p.to(dt)),
        )
        return BlockArray.from_torch(G, backend=self.backend)

    def _reduce0_ooc(self, X, op):
        d = X.shape[1] if X.ndim == 2 else 1
        dt = _device_dtype(self.backend, X.dtype)
        if dt.is_floating_point:
            init_val = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
        else:
            # ±inf cast to an integer would be INT_MIN, which absorbs
            # min: the dtype's own bounds are the identities.
            info = torch.iinfo(dt)
            init_val = {"sum": 0, "min": info.max, "max": info.min}[op]
        shape = (d,) if X.ndim == 2 else ()
        acc = self._ooc_accumulate(
            X, torch.full(shape, init_val, dtype=dt),
            lambda a, p: streaming.reduce0_update(op, a, p.to(dt)), op=op,
        )
        return BlockArray.from_torch(acc, backend=self.backend)

    def sum_ooc(self, X) -> BlockArray:
        """Column sums (axis=0) of a DiskArray, one streamed pass."""
        return self._reduce0_ooc(X, "sum")

    def min_ooc(self, X) -> BlockArray:
        return self._reduce0_ooc(X, "min")

    def max_ooc(self, X) -> BlockArray:
        return self._reduce0_ooc(X, "max")

    def mean_ooc(self, X) -> BlockArray:
        return self.sum_ooc(X) / float(X.shape[0])

    def tsqr_r_ooc(self, X) -> BlockArray:
        """R factor of a DiskArray by the streamed Householder combine
        R <- qr_r([R; panel]), stable at any conditioning. On the mesh each
        process combines its own rows, then the R's of every process are
        stacked and factored once (``streaming.tsqr_r_combine``)."""
        assert X.ndim == 2
        d = X.shape[1]
        dt = _device_dtype(self.backend, X.dtype)
        chunk = linalg.choose_chunk(X.shape[0], d)
        R = self._ooc_accumulate(
            X, torch.zeros((d, d), dtype=dt),
            lambda acc, p: streaming.tsqr_r_update(chunk, acc, p.to(dt)),
            op=None,
        )
        R = streaming.tsqr_r_combine(self.backend.mesh, chunk, R)
        return BlockArray.from_torch(R, backend=self.backend)

    def linear_regression_ooc(self, X, y, lamb: float = 0.0) -> BlockArray:
        """(Ridge) regression on a DiskArray: one streamed pass of the
        normal equations (XᵀX on the gram kernel), then one (d, d)
        solve."""
        assert X.ndim == 2
        d = X.shape[1]
        dt = _device_dtype(self.backend, X.dtype)
        y_at = _ooc_y_getter(X, y)
        G = ooc_accumulator(self.backend, torch.zeros((d, d), dtype=dt))
        b = ooc_accumulator(self.backend, torch.zeros((d,), dtype=dt))
        for start, panel in ooc_panels(X):
            p, _ = ooc_put(self.backend, panel)
            yp, _ = ooc_put(self.backend, y_at(start, panel.shape[0]))
            x, yl = streaming.local_rows(p), streaming.local_rows(yp)
            if x.shape[0]:
                streaming.normal_eq_update(G, b, x.to(dt), yl.to(dt))
        streaming.reduce_rows(self.backend.mesh, [G, b])
        if lamb:
            G = G + lamb * torch.eye(d, dtype=dt, device=G.device)
        theta = linalg.posdef_solve(G, b)
        return BlockArray.from_torch(theta, backend=self.backend)

    # ------------------------------------------------------------------
    # Random
    # ------------------------------------------------------------------

    @property
    def random(self) -> NumsRandomState:
        """The application's own random state, built at first use."""
        if self._random is None:
            self._random = self.random_state()
        return self._random

    def random_state(self, seed=None):
        return NumsRandomState(self.backend, seed)
