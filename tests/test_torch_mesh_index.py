"""The ``index`` table of tests/mesh_tables.py (indexing, masks and
where/nonzero) on the (4, 1) mesh: the port's mesh against nums_tpu's mesh
and the port's serial backend, one case an entry (the tolerances are the
table's). Then where the rows of a data-dependent result land, and that
no op of the mesh's data-dependent branch (core/ops/mesh_ops.py) gathers a
sharded operand whole: ``DTensor.full_tensor``, and every redistribution
of a sharded DTensor of more than ``WHOLE_LIMIT`` elements to Replicate on
every mesh dimension (DTensor's own or ``MeshBackend.rebox``), raise while
they run (``torch_parity.refusing_gathers``, ``WHOLE_LIMIT``)."""

import numpy as np
import pytest

from mesh_tables import X37, X1003, C1003, S1003, check_entry, names, \
    table_fixtures
from torch_parity import (  # noqa: F401
    mesh_app, mesh_pool, refusing_gathers, torch_app,
)

port_mesh, reference_mesh, port_serial = table_fixtures("index", (4, 1))


@pytest.mark.parametrize("name", names("index"))
def test_entry(port_mesh, reference_mesh, port_serial, name):
    check_entry(port_mesh, reference_mesh, port_serial, name)


def _local_rows(cluster, keep):
    """Each rank's rows of ``X37[keep]`` read through the mesh, and of the
    where() of the same mask."""
    import torch.distributed as dist

    app = mesh_app(cluster)
    bx = app.array(X37, block_shape=(5, 6))
    mask = app.array(keep, block_shape=(5,))
    rows = bx[mask]
    (idx,) = app.where(mask)
    mine = (int(rows.raw.to_local().shape[0]),
            int(idx.raw.to_local().shape[0]))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return rows.shape, every, np.array_equal(rows.get(), X37[keep])


@pytest.mark.parametrize("keep,rows", [
    (np.ones(37, dtype=bool), [10, 10, 10, 7]),
    (np.isin(np.arange(37), [0, 9, 18, 27, 36]), [2, 2, 1, 0]),
    (np.arange(37) >= 30, [2, 2, 2, 1]),
    (np.zeros(37, dtype=bool), [0, 0, 0, 0])])
def test_rows_land_where_app_array_puts_them(mesh_pool, keep, rows):
    """On the (4, 1) mesh a mask's rows are re-placed as DTensor's chunks
    of ceil(m / 4): 37 kept rows split 10/10/10/7, 5 split 2/2/1/0, the 7
    rows that all lay on the last rank spread 2/2/2/1, none leave every
    rank empty; where() of the mask (a 1-D result over the whole mesh)
    likewise."""
    shape, every, same = mesh_pool.run(_local_rows, (4, 1), keep)
    assert same and shape == (int(keep.sum()), 6)
    assert [r for r, _ in every] == rows
    assert [w for _, w in every] == rows


def _no_gather(cluster):
    """Every op of the mesh's data-dependent branch on sharded operands,
    with whole copies refused; then the values against numpy, and the
    bytes that the row mask's all-to-all sent from each rank against the
    rows it kept."""
    import torch.distributed as dist

    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core import multiprocess

    app = mesh_app(cluster)
    bx = app.array(X1003, block_shape=(126, 7))
    col = app.array(X1003[:, 0], block_shape=(126,))
    c = app.array(C1003, block_shape=(126,))
    s = app.array(S1003, block_shape=(126,))
    t = app.array(C1003[::3] + 7, block_shape=(40,))
    mask = bx[:, 0] > 0
    keep = X1003[:, 0] > 0
    every_row = bx[:, 0] > -np.inf
    n_pos = int((X1003 > 0).sum())
    odd = np.arange(1, 1003, 2)

    def written(key, value):
        out = app.array(X1003.copy(), block_shape=(126, 7))
        out[key] = value
        return out

    def expected(key, value):
        out = X1003.copy()
        out[key] = value
        return out

    column = np.arange(1003.0)[:, None]
    slabs = np.arange(1400.0).reshape(200, 7)
    short = X1003[:1002, 5] > 0
    # the factorizations of a sharded 40x40 (1600 elements); device index
    # arrays (and one beside a device mask) read and written
    spd = X1003[:40, :5] @ X1003[:40, :5].T + 40.0 * np.eye(40)
    bspd = app.array(spd, block_shape=(10, 20))
    rhs = X1003[:40, 6]
    rows = np.random.RandomState(9).randint(0, 1003, size=700)
    cols = rows % 7
    drows = app.array(rows, block_shape=(100,))
    dcols = app.array(cols, block_shape=(100,))
    n_keep = int(keep.sum())
    kcols = np.arange(n_keep) % 7

    def pca_values():
        from nums_tpu_torch.core import settings
        from nums_tpu_torch.models.decomposition import PCA

        saved = settings.tsqr_method
        settings.tsqr_method = "cholqr2"
        try:
            return PCA(3).fit(bx).singular_values_
        finally:
            settings.tsqr_method = saved

    ops = [
        ("rows", lambda: bx[mask], X1003[keep]),
        ("elements", lambda: bx[bx > 0], X1003[X1003 > 0]),
        ("where", lambda: app.where(bx > 1.0), np.where(X1003 > 1.0)),
        ("argwhere", lambda: nps.argwhere(bx > 1.0),
         np.argwhere(X1003 > 1.0)),
        ("flatnonzero", lambda: nps.flatnonzero(bx > 1.0),
         np.flatnonzero(X1003 > 1.0)),
        ("compress", lambda: nps.compress(mask, bx, axis=0), X1003[keep]),
        ("extract", lambda: nps.extract(bx > 1.0, bx),
         X1003[X1003 > 1.0]),
        ("host_rows", lambda: bx[np.arange(1002, 0, -3)],
         X1003[np.arange(1002, 0, -3)]),
        ("host_pairs", lambda: bx[np.arange(900), np.arange(900) % 7],
         X1003[np.arange(900), np.arange(900) % 7]),
        ("unique", lambda: nps.unique(c, return_index=True,
                                      return_inverse=True,
                                      return_counts=True),
         np.unique(C1003, return_index=True, return_inverse=True,
                   return_counts=True)),
        ("unique_floats", lambda: nps.unique(bx), np.unique(X1003)),
        ("isin", lambda: nps.isin(c, t), np.isin(C1003, C1003[::3] + 7)),
        ("intersect1d", lambda: nps.intersect1d(c, t),
         np.intersect1d(C1003, C1003[::3] + 7)),
        ("union1d", lambda: nps.union1d(c, t),
         np.union1d(C1003, C1003[::3] + 7)),
        ("setdiff1d", lambda: nps.setdiff1d(c, t),
         np.setdiff1d(C1003, C1003[::3] + 7)),
        ("setxor1d", lambda: nps.setxor1d(c, t),
         np.setxor1d(C1003, C1003[::3] + 7)),
        ("searchsorted", lambda: nps.searchsorted(s, col),
         np.searchsorted(S1003, X1003[:, 0])),
        ("digitize", lambda: nps.digitize(col, s),
         np.digitize(X1003[:, 0], S1003)),
        ("interp", lambda: nps.interp(col, s, s * 2.0),
         np.interp(X1003[:, 0], S1003, S1003 * 2.0)),
        ("bincount", lambda: nps.bincount(c), np.bincount(C1003)),
        ("histogram", lambda: nps.histogram(bx, 16),
         np.histogram(X1003, 16)),
        ("histogram2d", lambda: nps.histogram2d(col, s, 5),
         np.histogram2d(X1003[:, 0], S1003, 5)),
        ("histogramdd", lambda: nps.histogramdd(bx, 2)[0],
         np.histogramdd(X1003, 2)[0]),
        ("trim_zeros", lambda: nps.trim_zeros(c), np.trim_zeros(C1003)),
        ("insert", lambda: nps.insert(bx, 500, 1.0, axis=0),
         np.insert(X1003, 500, 1.0, axis=0)),
        ("insert_slabs", lambda: nps.insert(
            bx, 500, app.array(slabs, block_shape=(50, 7)), axis=0),
         np.insert(X1003, 500, slabs, axis=0)),
        ("compress_short", lambda: nps.compress(
            app.array(short, block_shape=(126,)), bx, axis=0),
         np.compress(short, X1003, axis=0)),
        ("packed", lambda: written(bx > 0, app.array(
            np.arange(float(n_pos)), block_shape=(500,))),
         expected(X1003 > 0, np.arange(float(n_pos)))),
        ("packed_broadcast", lambda: written(every_row, app.array(
            column, block_shape=(126, 1))), expected(slice(None), column)),
        ("host_write_rows", lambda: written(odd, app.array(
            np.ones((501, 7)), block_shape=(126, 7))),
         expected(odd, 1.0)),
        ("inv", lambda: app.inv(bspd), np.linalg.inv(spd)),
        ("cholesky", lambda: app.cholesky(bspd), np.linalg.cholesky(spd)),
        ("posdef_solve", lambda: app.posdef_solve(bspd, app.array(
            rhs, block_shape=(10,))), np.linalg.solve(spd, rhs)),
        ("device_rows", lambda: bx[drows], X1003[rows]),
        ("device_pairs", lambda: bx[drows, dcols], X1003[rows, cols]),
        ("device_write_rows", lambda: written(drows, 3.0),
         expected(rows, 3.0)),
        ("device_write_pairs", lambda: written((drows, dcols), app.array(
            np.arange(700.0), block_shape=(100,))),
         expected((rows, cols), np.arange(700.0))),
        ("mask_device_index", lambda: bx[mask, app.array(
            kcols, block_shape=(100,))], X1003[keep, kcols]),
        ("host_write_pairs", lambda: written(
            (np.arange(1003), np.arange(1003) % 7), app.array(
                np.arange(1003.0), block_shape=(126,))),
         expected((np.arange(1003), np.arange(1003) % 7),
                  np.arange(1003.0))),
        ("var_rows", lambda: app.var(bx, axis=0, ddof=1),
         X1003.var(axis=0, ddof=1)),
        ("std_all", lambda: bx.std(), X1003.std()),
        ("pca", pca_values, np.linalg.svd(X1003 - X1003.mean(axis=0),
                                          compute_uv=False)[:3]),
    ]
    before = multiprocess.EXCHANGED["bytes_sent"]
    # the rows this rank holds of bx (and keeps), and its part of the
    # mask, which is first laid out as bx's rows (a byte an element)
    a, b = app.backend.region(bx.shape, bx.raw.placements)[0]
    bound = int(keep[a:b].sum()) * 7 * 8 + int(mask.raw.to_local().numel())
    undo = refusing_gathers()
    got, refused = {}, {}
    try:
        for name, fn, _ in ops:
            try:
                got[name] = fn()
            except AssertionError as e:
                refused[name] = str(e)
            if name == "rows":
                sent = multiprocess.EXCHANGED["bytes_sent"] - before
    finally:
        undo()

    def host(x):
        if isinstance(x, (tuple, list)):
            return [host(v) for v in x]
        return np.asarray(x.get())

    wrong = []
    for name, _, ref in ops:
        if name in got:
            vals = host(got[name])
            refs = list(ref) if isinstance(ref, tuple) else ref
            if not all(np.allclose(v, r) for v, r in zip(
                    vals if isinstance(vals, list) else [vals],
                    refs if isinstance(refs, list) else [refs])):
                wrong.append(name)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (refused, sent, bound))
    return wrong, every


@pytest.mark.parametrize("cluster", [(4, 1), (2, 2)])
def test_no_op_gathers_a_sharded_operand(mesh_pool, cluster):
    """No data-dependent op of the mesh, no write of a sharded value by a
    mask or a host index array, no read or write by a device index array
    (beside a device mask too), none of the factorizations of a sharded
    square matrix (inv, cholesky, posdef_solve), no variance and no PCA
    fit copies a sharded operand whole to a process; each gives numpy's values, and the row mask sends from each rank no more
    than the rows it kept and its part of the mask."""
    wrong, every = mesh_pool.run(_no_gather, cluster)
    for refused, sent, kept in every:
        assert not refused, refused
        assert sent <= kept, (sent, kept)
    assert not wrong, wrong
