"""What the benchmark takes from the program: its application on this
process's device, the inputs handed to it as arrays, its answers as plain
tensors, and its counters. Only the call modules and the session import
the program, and only through here or inside their functions."""


def application(device, world, cluster_shape):
    """The program's application: the serial backend on one device, or
    the mesh of ``cluster_shape`` over the joined processes."""
    from nums_tpu_torch.core import application_manager

    asked = None if device.type == "cuda" else device.type
    if world == 1:
        app = application_manager.create(asked, backend="serial")
    else:
        app = application_manager.create(
            asked, backend="mesh", cluster_shape=tuple(cluster_shape))
    application_manager.set_instance(app)
    return app


def row_array(app, local, n_rows):
    """A BlockArray of ``n_rows`` rows (every column) whose rows here are
    ``local``: the whole tensor on one device; on the mesh, this process's
    rows, placed without communication as the program's region reader
    places them."""
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.grid import ArrayGrid
    from nums_tpu_torch.core.array import utils as array_utils

    backend = app.backend
    shape = (int(n_rows),) + tuple(local.shape[1:])
    if backend.mesh is None:
        return BlockArray.from_torch(local, block_shape=shape,
                                     backend=backend)
    world = backend.num_devices
    block = (-(-shape[0] // world),) + shape[1:]
    grid = ArrayGrid(shape, block, array_utils.to_dtype_name(local.dtype))
    placements = backend.sharding_for_grid(grid)
    box = backend.region(shape, placements)
    if tuple(box[0]) != rows_of(shape[0], world, _rank()):
        raise ValueError(f"rows here {box[0]} differ from the inputs' rows")
    data = backend.from_local(local, shape, placements)
    return BlockArray(data, grid, backend)


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def rows_of(n, world, rank):
    """(start, stop) of the rows that ``rank`` of ``world`` holds."""
    per = -(-n // world)
    return (min(n, rank * per), min(n, (rank + 1) * per))


def whole(t):
    """A tensor of the program, whole on this process (collective for a
    sharded or replicated DTensor)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def launches():
    """The program's kernel launch counters, by name."""
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    return {**cuda_gram.LAUNCHES, **cuda_newton.LAUNCHES}


def release():
    """Drop the program's application (the process group stays: the
    reference sums over it)."""
    from nums_tpu_torch.core import application_manager

    application_manager.destroy()
