"""Execution backend: where arrays live.

Counterpart of ``nums_tpu/core/backend.py``. On ``SerialBackend`` an
array is ONE ``torch.Tensor`` on the backend's ``torch.device``; every op
is a torch call on it. On ``MeshBackend`` it is one ``DTensor`` over a
``DeviceMesh`` of one process per device, placed by the reference's rule
(``MeshBackend._axis_plan``). The at-rest shape equals the logical shape
on both: the reference pads the minor axis to the TPU's 128 lanes and, on
the mesh, ragged axes to the mesh multiple; DTensor's uneven shards give
every device the same rows without the pad.
"""

import threading

import numpy as np
import torch

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.grid import ArrayGrid, DeviceGrid, shard_region

# Transfers to the host made by this thread (``Backend.get``, which
# ``BlockArray.get``, ``float()``, ``bool()``, ``item()`` and ``print``
# go through): ``autodiff`` raises when one fires inside a differentiated
# function, as the reference's ``lazy.materialize_count`` lets it.
_tls = threading.local()


def host_sync_count() -> int:
    return getattr(_tls, "count", 0)


class Backend:
    """Common backend interface."""

    name = None

    def init(self):
        return self

    def shutdown(self):
        pass

    @property
    def num_devices(self):
        raise NotImplementedError

    @property
    def num_cores_total(self):
        # Drives the block-shape policy: "cores" are devices.
        return self.num_devices

    @property
    def default_float(self) -> np.dtype:
        return settings.default_float_for(self.device)

    def device_dtype(self, dtype) -> np.dtype:
        """The dtype that host data of ``dtype`` takes on the device:
        where the default float is float32 (an accelerator), float64 and
        complex128 arrive as float32 and complex64, as the reference's
        device_put with x64 off does."""
        dtype = np.dtype(dtype)
        if self.default_float == np.float32:
            return {np.dtype(np.float64): np.dtype(np.float32),
                    np.dtype(np.complex128): np.dtype(np.complex64)}.get(
                        dtype, dtype)
        return dtype

    def device_put(self, array: np.ndarray, grid: ArrayGrid = None):
        """Host array -> tensor on the device (copied: the caller's array
        is never aliased), in ``device_dtype``: a host scalar such as
        ``app.one`` then keeps float32 math float32 on the card."""
        del grid
        array = np.array(array, order="C", copy=True)
        array = array.astype(self.device_dtype(array.dtype), copy=False)
        array_utils.to_torch_dtype(array.dtype)  # TypeError if not held
        return torch.from_numpy(array).to(self.device)

    def get(self, tensor) -> np.ndarray:
        _tls.count = host_sync_count() + 1
        return tensor.detach().cpu().numpy()

    @property
    def mesh(self):
        return None

    def place(self, data, grid: ArrayGrid, transposed=False):
        """``data`` laid out as ``grid`` says (a BlockArray's tensor goes
        through here): one device holds it whole."""
        del grid, transposed
        return data

    def local_region(self, grid: ArrayGrid):
        """The box of ``grid``'s array that this process holds, or None
        where it holds the whole array."""
        del grid
        return None


class SerialBackend(Backend):
    """Single-device backend on an explicit ``torch.device``. The default
    device is ``cuda:0``; where CUDA is missing, ``init`` raises: the CPU
    runs only when the caller asks for it (``device="cpu"``)."""

    name = "serial"

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def init(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "nums_tpu_torch: no CUDA device (torch.cuda.is_available()"
                    " is false); to run on the CPU, ask for it: "
                    "nums_tpu_torch.init(device=\"cpu\")"
                )
            self.device = torch.device("cuda:0")
        return self

    @property
    def num_devices(self):
        return 1


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def _stacked_rows(parts, box):
    """Whether the boxes ``parts`` (None: nothing), in order, tile ``box``
    along axis 0, each whole on every other axis."""
    at = box[0][0] if box else 0
    for part in parts:
        if part is None:
            continue
        if part[0][0] != at or tuple(part[1:]) != tuple(box[1:]):
            return False
        at = part[0][1]
    return bool(box) and at == box[0][1]


class MeshBackend(Backend):
    """SPMD backend: one process per device, arrays as DTensors.

    Counterpart of nums_tpu's ``MeshBackend``, whose mesh is one
    controller over all devices (a ``NamedSharding`` partitioned by XLA):
    here each process drives its own device, joined by ``torch.distributed``
    (NCCL on the card, gloo on the CPU; ``core/multiprocess.py``), and an
    array is a ``DTensor`` with one placement per mesh dimension. Array
    axis ``k`` is sharded over mesh dimension ``m{k}`` by the reference's
    rule (``_axis_plan``); a result that DTensor leaves elsewhere (a
    ``Partial`` sum, a replicated slice) is redistributed to that rule
    when a BlockArray takes it, as XLA places an output by its sharding.
    A plain tensor handed to a BlockArray is the whole value, the same on
    every process, and each keeps its own region of it.

    ``cluster_shape`` (default: (processes, 1)) must have as many devices
    as the group has processes; a process with no group forms a mesh of
    one device. The CPU runs only when asked for (``device="cpu"``)."""

    name = "mesh"

    def __init__(self, cluster_shape: tuple = None, device=None):
        self._cluster_shape = cluster_shape
        self._asked = device
        self.device = None
        self.device_grid = None
        self._mesh = None
        self._own_group = False

    def init(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from nums_tpu_torch.core import multiprocess

        self.device = multiprocess.device_for(self._asked)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        joined = multiprocess.initialize(self.device.type)
        world = dist.get_world_size() if joined else 1
        shape = tuple(self._cluster_shape or settings.cluster_shape
                      or (world, 1))
        if int(np.prod(shape)) != world:
            raise ValueError(
                f"mesh {shape} needs {int(np.prod(shape))} processes; the "
                f"group has {world} (one process per device)"
            )
        if not joined:
            multiprocess.initialize_single(self.device.type)
            self._own_group = True
        self.device_grid = DeviceGrid(shape)
        self._mesh = DeviceMesh(
            self.device.type, torch.arange(world).reshape(shape),
            mesh_dim_names=self.device_grid.axis_names,
        )
        return self

    def shutdown(self):
        import torch.distributed as dist

        self._mesh = None
        if self._own_group and dist.is_initialized():
            dist.destroy_process_group()
        self._own_group = False

    @property
    def mesh(self):
        return self._mesh

    @property
    def num_devices(self):
        return self.device_grid.num_devices

    @property
    def cluster_shape(self):
        return self.device_grid.mesh_shape

    # -- the reference's placement rule (nums_tpu backend.py:216-277) ----

    def _axis_plan(self, shape: tuple, grid_shape: tuple = None):
        """Per axis: (the reference's padded length, the mesh axis name,
        a tuple of names, or None). Axis ``k`` maps to ``m{k}`` when it is
        at least as long as the mesh there and its grid has more than one
        block; a 1-D array goes over the flattened mesh, else over ``m0``;
        with ``pad_shard`` off an axis the mesh does not divide is
        replicated."""
        pad = settings.pad_shard

        def fit(dim, m):
            if m <= 1 or dim < m:
                return None
            if dim % m == 0:
                return dim
            return -(-dim // m) * m if pad else None

        mesh_shape = self.device_grid.mesh_shape
        if len(shape) == 1:
            dim = shape[0]
            if grid_shape is None or grid_shape[0] > 1:
                p = fit(dim, self.device_grid.num_devices)
                if p is not None:
                    return [(p, self.device_grid.axis_names)]
                p = fit(dim, mesh_shape[0] if mesh_shape else 1)
                if p is not None:
                    return [(p, self.device_grid.axis_names[0])]
            return [(dim, None)]
        plan = []
        for k, dim in enumerate(shape):
            hint_ok = grid_shape is None or grid_shape[k] > 1
            p = (fit(dim, mesh_shape[k])
                 if k < len(mesh_shape) and hint_ok else None)
            if p is None:
                plan.append((dim, None))
            else:
                plan.append((p, self.device_grid.axis_names[k]))
        return plan

    def spec_for_shape(self, shape: tuple, grid_shape: tuple = None):
        """The reference's PartitionSpec entries, as a tuple."""
        return tuple(ax for _, ax in self._axis_plan(shape, grid_shape))

    def physical_shape(self, shape: tuple, grid_shape: tuple = None):
        """The reference's padded at-rest extents: the schedules of
        ``core/ops/summa.py`` dispatch on them, so every shape takes the
        reference's schedule. The port keeps the logical shape at rest."""
        if len(shape) == 0:
            return ()
        return tuple(p for p, _ in self._axis_plan(shape, grid_shape))

    def sharding_for_shape(self, shape: tuple, grid_shape: tuple = None):
        """DTensor placements (one per mesh dimension) for a shape."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.device_grid.mesh_shape)
        if len(shape) == 0:
            return tuple(out)
        names = self.device_grid.axis_names
        for k, ax in enumerate(self.spec_for_shape(shape, grid_shape)):
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    out[names.index(name)] = Shard(k)
        return tuple(out)

    def sharding_for_grid(self, grid: ArrayGrid):
        if grid is None:
            return self.replicated()
        return self.sharding_for_shape(grid.shape, grid.grid_shape)

    def replicated(self):
        from torch.distributed.tensor import Replicate

        return (Replicate(),) * len(self.device_grid.mesh_shape)

    # -- regions and DTensors --------------------------------------------

    def region(self, shape, placements, coord=None):
        """The box of an array of ``shape`` under ``placements`` that the
        mesh coordinate ``coord`` (default: this process's) holds."""
        dims = [p.dim if p.is_shard() else None for p in placements]
        if coord is None:
            coord = self._mesh.get_coordinate()
        return shard_region(shape, dims, self.device_grid.mesh_shape, coord)

    def local_region(self, grid: ArrayGrid):
        return self.region(grid.shape, self.sharding_for_grid(grid))

    def without_empty_shards(self, data):
        """``data``, replicated where some process holds none of it (an
        uneven shard can be empty, and a min or max of nothing fails)."""
        import itertools

        mesh_shape = self.device_grid.mesh_shape
        for coord in itertools.product(*(range(m) for m in mesh_shape)):
            box = self.region(tuple(data.shape), data.placements, coord)
            if any(b <= a for a, b in box):
                from nums_tpu_torch.core import multiprocess

                return multiprocess.sent_moved(data, data.redistribute(
                    self._mesh, self.replicated()))
        return data

    def from_local(self, local, shape, placements):
        """The DTensor of global ``shape`` whose region here is ``local``
        (no communication)."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            local, self._mesh, placements, run_check=False,
            shape=torch.Size(shape), stride=_contiguous_stride(shape),
        )

    def scatter_full(self, full, placements):
        """A whole value, the same on every process, as a DTensor: each
        process keeps a copy of its own region (no communication)."""
        box = self.region(tuple(full.shape), placements)
        local = full
        if box != tuple((0, int(s)) for s in full.shape):
            local = full[tuple(slice(a, b) for a, b in box)].clone()
        return self.from_local(local, tuple(full.shape), placements)

    def place(self, data, grid: ArrayGrid, transposed=False):
        from torch.distributed.tensor import DTensor

        shape, gshape = grid.shape, grid.grid_shape
        if transposed:
            shape, gshape = tuple(reversed(shape)), tuple(reversed(gshape))
        want = self.sharding_for_shape(shape, gshape)
        if not isinstance(data, DTensor):
            return self.scatter_full(data, want)
        if tuple(data.placements) != want:
            from nums_tpu_torch.core import multiprocess

            data = multiprocess.sent_moved(
                data, data.redistribute(self._mesh, want))
        return data

    # -- moving rows (the data-dependent ops of core/ops/masking.py) -----

    def coords(self):
        """Every process's mesh coordinate, in rank order (the mesh is the
        ranks in row-major order)."""
        shape = self.device_grid.mesh_shape
        return [tuple(int(c) for c in np.unravel_index(r, shape))
                for r in range(self.device_grid.num_devices)]

    def counts_here(self, placements) -> bool:
        """Whether this process's box counts in a sum over the mesh: of the
        processes that hold the same box (the mesh dimensions it is
        replicated on), only the first."""
        coord = self._mesh.get_coordinate()
        return all(p.is_shard() or coord[k] == 0
                   for k, p in enumerate(placements))

    def rebox(self, data, placements):
        """``data`` (a DTensor) laid out by ``placements``, by one
        all-to-all: each process sends each other the part of its box that
        lies in the other's new box. A part that several processes hold
        (replicated) comes from the holder that agrees with the receiver
        on the mesh dimensions it is replicated on. No process holds more
        than its old box, its new one and the parts it sends."""
        from nums_tpu_torch.core import multiprocess

        placements = tuple(placements)
        if tuple(data.placements) == placements:
            return data
        shape = tuple(data.shape)
        coords = self.coords()
        me = multiprocess.process_index()
        src = [self.region(shape, data.placements, c) for c in coords]
        dst = [self.region(shape, placements, c) for c in coords]
        if src == dst:  # a mesh dimension of one process: nothing moves
            return self.from_local(data.to_local(), shape, placements)
        rep = [k for k, p in enumerate(data.placements) if not p.is_shard()]

        def part(s, d):
            if any(coords[s][k] != coords[d][k] for k in rep):
                return None
            box = tuple((max(a, c), min(b, e))
                        for (a, b), (c, e) in zip(src[s], dst[d]))
            return None if any(b <= a for a, b in box) else box

        local = data.to_local()
        boxes, send = [], []
        for r in range(len(coords)):
            box = part(me, r)
            boxes.append(box)
            send.append(0 if box is None else
                        int(np.prod([b - a for a, b in box])))
        # the parts copied once, straight into the buffer that is sent
        flat = local.new_empty((sum(send),))
        at = 0
        for box, n in zip(boxes, send):
            if box is not None:
                flat[at:at + n].view(tuple(b - a for a, b in box)).copy_(
                    local[tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                                in zip(box, src[me]))])
                at += n
        recv_boxes = [part(r, me) for r in range(len(coords))]
        recv = [0 if box is None else int(np.prod([b - a for a, b in box]))
                for box in recv_boxes]
        got = multiprocess.exchange(flat, send, recv)
        del flat
        out_shape = tuple(b - a for a, b in dst[me])
        if _stacked_rows(recv_boxes, dst[me]):
            # the parts arrive in the order of their rows, each whole on
            # the other axes: the received buffer is the new box
            return self.from_local(got.reshape(out_shape), shape,
                                   placements)
        out = local.new_empty(out_shape)
        at = 0
        for box, n in zip(recv_boxes, recv):
            if box is None:
                continue
            out[tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                      in zip(box, dst[me]))] = got[at:at + n].reshape(
                          tuple(b - a for a, b in box))
            at += n
        return self.from_local(out, shape, placements)

    def _row_groups(self, placements):
        """(this process's row group, its position there): the processes
        that agree with it on every mesh dimension that does not shard
        axis 0, in rank order. They hold the array's rows between them;
        each other group holds the same rows (replicas, or other column
        blocks)."""
        from nums_tpu_torch.core import multiprocess

        coords = self.coords()
        me = multiprocess.process_index()
        other = [k for k, p in enumerate(placements)
                 if not (p.is_shard() and p.dim == 0)]
        group = [r for r in range(len(coords))
                 if all(coords[r][k] == coords[me][k] for k in other)]
        return group, group.index(me)

    def move_rows(self, local, src_ranges, dst_ranges, placements):
        """Rows of one global sequence from where they are to where they
        go, by one all-to-all within each row group of ``placements``:
        ``src_ranges[r]`` and ``dst_ranges[r]`` are the (start, stop) rows
        that process ``r`` holds now (``local`` here) and will hold.
        Returns this process's new rows, in order."""
        return self.move_pieces([local], [[r] for r in src_ranges],
                                dst_ranges, placements)

    def move_pieces(self, locals_, src_pieces, dst_ranges, placements):
        """``move_rows`` where each process holds several runs of the
        sequence: ``src_pieces[r]`` lists the (start, stop) runs that
        process ``r`` holds (``locals_``, one tensor a run, here), disjoint;
        ``dst_ranges[r]`` the one range it will hold. Within each row group
        of ``placements``, one all-to-all a round, the round j moving each
        process's j-th run, received straight into its place in the result
        where it arrives in order (so a join or a repeat copies nothing
        but the rows received); where every process keeps what it has,
        nothing moves, and this process's one run comes back as it is.
        Returns this process's new rows, in order."""
        from nums_tpu_torch.core import multiprocess

        group, _ = self._row_groups(placements)
        me = multiprocess.process_index()
        world = self.device_grid.num_devices
        if all(len(src_pieces[r]) == 1 and tuple(src_pieces[r][0])
               == tuple(dst_ranges[r]) for r in range(world)):
            return locals_[0]
        rounds = max(len(src_pieces[r]) for r in group)
        lo, hi = dst_ranges[me]
        out = None

        def overlap(a, b):
            return max(a[0], b[0]), min(a[1], b[1])

        for j in range(rounds):
            send, recv, cuts, runs = [0] * world, [0] * world, [], []
            mine = src_pieces[me][j] if j < len(src_pieces[me]) else None
            local = locals_[j] if mine is not None else locals_[0][:0]
            for r in group:
                if mine is not None:
                    a, b = overlap(mine, dst_ranges[r])
                    if b > a:
                        send[r] = b - a
                        cuts.append((a - mine[0], b - mine[0]))
                if j < len(src_pieces[r]):
                    a, b = overlap(src_pieces[r][j], dst_ranges[me])
                    if b > a:
                        recv[r] = b - a
                        runs.append((a, b))
            # this process's parts in order: one slice of its run where
            # they meet, else a copy of them
            if all(c[1] == n[0] for c, n in zip(cuts, cuts[1:])):
                items = local[cuts[0][0]:cuts[-1][1]] if cuts else local[:0]
            else:
                items = torch.cat([local[a:b] for a, b in cuts])
            in_order = all(r[1] == n[0] for r, n in zip(runs, runs[1:]))
            if rounds == 1 and in_order and (not runs or runs[0][0] == lo
                                             and runs[-1][1] == hi):
                return multiprocess.exchange(items, send, recv)
            if out is None:
                out = local.new_empty((hi - lo,) + tuple(local.shape[1:]))
            if in_order:
                at = runs[0][0] - lo if runs else 0
                multiprocess.exchange(items, send, recv, out=out[
                    at:at + sum(recv)])
            else:
                got = multiprocess.exchange(items, send, recv)
                at = 0
                for a, b in runs:
                    out[a - lo:b - lo] = got[at:at + b - a]
                    at += b - a
        return out

    def place_rows(self, local, tail, placements):
        """The mesh's re-placement of a data-dependent number of rows: each
        process holds ``local``, its kept rows; the rows of a row group
        (``_row_groups``), read in rank order, are the result's rows in
        order. Returns the DTensor of shape (total rows,) + ``tail`` laid
        out by ``placements`` (axis 0: DTensor's chunks of ceil(rows / p),
        none on a process past the end), after one all-gather of the
        counts and one all-to-all of the rows; no process holds more than
        its kept rows and its share."""
        from nums_tpu_torch.core import multiprocess

        counts = multiprocess.all_gather_ints([local.shape[0]])[:, 0]
        group, _ = self._row_groups(placements)
        starts = np.zeros(len(counts), dtype=np.int64)
        total = 0
        for r in group:
            starts[r] = total
            total += int(counts[r])
        shape = (total,) + tuple(tail)
        src = [(int(starts[r]), int(starts[r] + counts[r]))
               for r in range(len(counts))]
        dst = [self.region(shape, placements, c)[0] for c in self.coords()]
        rows = self.move_rows(local, src, dst, placements)
        return self.from_local(rows, shape, placements)

    def device_put(self, array: np.ndarray, grid: ArrayGrid = None):
        """Each process copies its own region of the host value (which
        every controller holds) to its device: no communication."""
        array = np.asarray(array)
        array = array.astype(self.device_dtype(array.dtype), copy=False)
        array_utils.to_torch_dtype(array.dtype)  # TypeError if not held
        placements = self.sharding_for_grid(grid)
        box = self.region(array.shape, placements)
        local = np.array(array[tuple(slice(a, b) for a, b in box)],
                         order="C", copy=True)
        return self.from_local(torch.from_numpy(local).to(self.device),
                               array.shape, placements)

    def device_reshard(self, data, grid: ArrayGrid):
        """An on-device value laid out as ``grid`` says (``redistribute``
        for a DTensor)."""
        return self.place(data, grid)

    def get(self, tensor) -> np.ndarray:
        """The whole value on every process (collective: ``full_tensor``)."""
        from torch.distributed.tensor import DTensor

        if isinstance(tensor, DTensor):
            from nums_tpu_torch.core import multiprocess

            tensor = multiprocess.sent_gather(tensor).full_tensor()
        return super().get(tensor)


_BACKENDS = {"serial": SerialBackend, "mesh": MeshBackend}


def make_backend(name: str = None, **kwargs) -> Backend:
    name = name or settings.backend_name
    if name not in _BACKENDS:
        raise ValueError(
            f"Unknown backend {name!r}; expected one of {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name](**kwargs).init()
