"""The port's collective I/O on 4 processes against nums_tpu's.

The port's mesh runs in the 4 gloo processes of ``mesh_pool`` on a (4, 1)
mesh over a shared directory; nums_tpu runs in the test process, on its
mesh over the 8 virtual CPU devices (``jax_mesh``). The cases follow
sections 2-4 of the worker of tests/test_multihost.py:

* checkpoints written by each block's owner (once, into the shared
  ``.tmp-0`` directories, nothing left behind), their stored grid the
  reference's shard grid (``_shard_grid_blocks``), and round trips of a
  32x8 array in 4-row blocks, a ragged 13x3, a transposed view, a 3-D
  array and 5 rows over 4 processes (one shard empty);
* checkpoints moving between the packages both ways;
* replica failover where another rank corrupted the block, the collective
  ``verify_fs(repair=True)`` (the same report on every rank), the
  collective ``delete_fs``, S3 objects through one file-backed fake;
* ``read_csv`` and ``read_parquet`` of 37 rows, each rank parsing only its
  rows; ``write_parquet`` of a BlockArray and of a DiskArray and
  ``read_parquet(out=)`` (process 0 writes, every rank opens the file);
  ``from_pandas`` by region; step checkpoints, where ``save_async`` saves
  at once under several processes.

Everything runs in float64 on the CPU, where a round trip is exact: each
comparison is bitwise.
"""

import os

import numpy as np
import pytest

from torch_parity import jax_mesh, mesh_app, mesh_pool  # noqa: F401

SEED = 11
# name -> (shape, block shape, transposed)
ROUND_TRIPS = {
    "32x8": ((32, 8), (4, 8), False),
    "ragged_13x3": ((13, 3), (4, 3), False),
    "transposed": ((32, 8), (4, 8), True),
    "3d": ((8, 6, 4), (2, 6, 4), False),
    "5_rows": ((5, 3), (2, 3), False),
    # 1-D over both axes of a (2, 2) mesh: DTensor's nested chunks of 13
    # rows (4/3/3/3) are not the reference's blocks of 4.
    "13_on_2x2": ((13,), (4,), False),
}
CLUSTERS = {"13_on_2x2": (2, 2)}


def _values(shape, seed=SEED):
    return np.random.RandomState(seed).randn(*shape)


def _gather(obj):
    """Every rank's ``obj``, in rank order (collective)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------
# Cases: top-level functions run on every rank of the pool
# ---------------------------------------------------------------------


def _round_trip_case(root, name):
    from nums_tpu_torch.core.io.filesystem import _fs_path

    app = mesh_app(CLUSTERS.get(name, (4, 1)))
    shape, block, transposed = ROUND_TRIPS[name]
    ba = app.array(_values(shape), block_shape=block)
    if transposed:
        ba = ba.T
    path = os.path.join(root, name)
    app.write_fs(ba, path)
    with open(os.path.join(_fs_path(path), "meta.pkl"), "rb") as f:
        import pickle

        meta = pickle.load(f)
    back = app.read_fs(path)
    local = tuple(back.raw.to_local().shape)
    return back.get(), meta["grid"], sorted(meta["checksums"]), \
        _gather(local)


def _writes_case(root):
    """Which rank wrote which file of a 4-block checkpoint: every write of
    the block engine and of np.save is recorded."""
    import torch.distributed as dist

    from nums_tpu_torch.core.io import filesystem

    app = mesh_app()
    ba = app.array(_values((32, 8)), block_shape=(8, 8))
    written = []
    native = filesystem.shard_native.write_shards
    save = filesystem.np.save

    def write_shards(items):
        written.extend(p for p, _ in items)
        return native(items)

    def np_save(path, arr, *args, **kwargs):
        written.append(str(path))
        return save(path, arr, *args, **kwargs)

    filesystem.shard_native.write_shards = write_shards
    filesystem.np.save = np_save
    try:
        app.write_fs(ba, os.path.join(root, "owned"))
    finally:
        filesystem.shard_native.write_shards = native
        filesystem.np.save = save
    dist.barrier()
    return _gather(written), sorted(os.listdir(root))


def _write_case(root, name):
    app = mesh_app()
    shape, block, _ = ROUND_TRIPS[name]
    app.write_fs(app.array(_values(shape), block_shape=block),
                 os.path.join(root, name))


def _read_case(root, name):
    app = mesh_app()
    back = app.read_fs(os.path.join(root, name))
    return back.get(), _gather(tuple(back.raw.to_local().shape))


def _failover_case(root):
    import glob

    from nums_tpu_torch.core import multiprocess

    app = mesh_app()
    x = _values((32, 8))
    path = os.path.join(root, "repl")
    app.write_fs(app.array(x, block_shape=(8, 8)), path, replicas=2)
    multiprocess.barrier("pre-corrupt")
    if multiprocess.process_index() == 3:  # rank 0's block, by rank 3
        victim = sorted(glob.glob(os.path.join(path, "block_*.npy")))[0]
        with open(victim, "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef" * 8)
    multiprocess.barrier("post-corrupt")
    checked = app.read_fs(path, verify=True).get()
    report = app.verify_fs(path, repair=True)
    after = app.verify_fs(path)
    # A primary that is gone fails over without verify too.
    multiprocess.barrier("pre-remove")
    if multiprocess.process_index() == 2:
        os.remove(os.path.join(path, "block_1_0.npy"))
    multiprocess.barrier("post-remove")
    missing = app.read_fs(path).get()
    return checked, _gather(report), after, missing


def _delete_case(root):
    app = mesh_app()
    path = os.path.join(root, "gone")
    app.write_fs(app.array(_values((13, 3)), block_shape=(4, 3)), path,
                 replicas=2)
    first = app.delete_fs(path)
    second = app.delete_fs(path)
    left = sorted(e for e in os.listdir(root) if e.startswith("gone"))
    return _gather((bool(first[0]), bool(second[0]))), left


def _s3_case(fake_dir):
    import nums_tpu_torch as ntt
    from nums_tpu_torch.core import multiprocess

    app = mesh_app()
    os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"] = fake_dir
    try:
        if multiprocess.process_index() == 0:
            app.fs._s3_client().create_bucket(Bucket="bkt")
        multiprocess.barrier("bucket")
        ntt.api.write(app.array(_values((13, 3)), block_shape=(4, 3)),
                      "s3://bkt/port")
        back = ntt.api.read("s3://bkt/port").get()
        ref = ntt.api.read("s3://bkt/ref").get()
        keys = sorted(os.listdir(os.path.join(fake_dir, "bkt")))
        ntt.api.delete("s3://bkt/gone")
        after = sorted(os.listdir(os.path.join(fake_dir, "bkt")))
    finally:
        del os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"]
    return back, ref, keys, after


def _csv_case(csv_path, pq_path):
    import nums_tpu_torch as ntt
    from nums_tpu_torch.core.io import _native

    mesh_app()
    parsed = []
    parse = _native.parse_bytes

    def spy(raw, delimiter):
        arr, ok = parse(raw, delimiter)
        parsed.append(arr.shape[0] if ok else None)
        return arr, ok

    _native.parse_bytes = spy
    try:
        X = ntt.api.read_csv(csv_path, has_header=True)
    finally:
        _native.parse_bytes = parse
    out = {"csv": X.get(), "csv_rows": _gather(parsed)}
    if pq_path is not None:
        import pyarrow.parquet as pq

        decoded = []
        read = pq.ParquetFile.read_row_group

        def spy_group(self, i, *args, **kwargs):
            decoded.append(i)
            return read(self, i, *args, **kwargs)

        pq.ParquetFile.read_row_group = spy_group
        try:
            P = ntt.api.read_parquet(pq_path)
        finally:
            pq.ParquetFile.read_row_group = read
        out["parquet"] = P.get()
        out["parquet_groups"] = _gather(sorted(set(decoded)))
        out["parquet_rows"] = _gather(tuple(P.raw.to_local().shape))
    return out


# ---------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------


def _reference_grid(jax_mesh, name):
    """nums_tpu's stored grid for the case on its (4, 1) mesh."""
    shape, block, transposed = ROUND_TRIPS[name]
    rba = jax_mesh.array(_values(shape), block_shape=block)
    if transposed:
        rba = rba.T
    grid, _ = jax_mesh.fs._shard_grid_blocks(rba)
    return grid.to_meta()


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_round_trip_is_bitwise(mesh_pool, jax_mesh, tmp_path, name):
    got, grid, blocks, locals_ = mesh_pool.run(_round_trip_case,
                                               str(tmp_path), name)
    shape, _, transposed = ROUND_TRIPS[name]
    want = _values(shape).T if transposed else _values(shape)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    ref = _reference_grid(jax_mesh, name)
    assert tuple(grid["shape"]) == tuple(ref["shape"])
    assert tuple(grid["block_shape"]) == tuple(ref["block_shape"])
    from nums_tpu.core.grid import ArrayGrid

    names = sorted("block_" + "_".join(map(str, e)) + ".npy" for e in
                   ArrayGrid.from_meta(ref).get_entry_iterator())
    assert blocks == names
    assert sum(np.prod(s) for s in locals_) >= np.prod(shape)
    if name == "5_rows":  # 2/2/1/0 rows: one rank holds none
        assert [s[0] for s in locals_] == [2, 2, 1, 0]
    if name == "13_on_2x2":
        assert [s[0] for s in locals_] == [4, 3, 3, 3]


def test_each_block_is_written_once_by_its_owner(mesh_pool, tmp_path):
    written, entries = mesh_pool.run(_writes_case, str(tmp_path))
    blocks = {}
    for rank, paths in enumerate(written):
        for p in paths:
            blocks.setdefault(os.path.basename(p), []).append(
                (rank, os.path.basename(os.path.dirname(p))))
    # 32 rows over 4 ranks: block i is rank i's rows.
    assert blocks == {f"block_{i}_0.npy": [(i, "owned.tmp-0")]
                      for i in range(4)}
    assert entries == ["owned"]  # published; no .tmp-<pid> left behind


@pytest.mark.parametrize("name", ["32x8", "ragged_13x3", "5_rows"])
def test_checkpoints_move_between_the_packages(mesh_pool, jax_mesh,
                                               tmp_path, name):
    shape, block, _ = ROUND_TRIPS[name]
    x = _values(shape)
    mesh_pool.run(_write_case, str(tmp_path), name)
    assert np.array_equal(
        np.asarray(jax_mesh.read_fs(str(tmp_path / name)).get()), x)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    jax_mesh.write_fs(jax_mesh.array(x, block_shape=block),
                      str(ref_dir / name))
    got, _ = mesh_pool.run(_read_case, str(ref_dir), name)
    assert got.dtype == np.float64 and np.array_equal(got, x)


def test_failover_and_collective_repair(mesh_pool, tmp_path):
    checked, reports, after, missing = mesh_pool.run(_failover_case,
                                                     str(tmp_path))
    x = _values((32, 8))
    assert np.array_equal(checked, x)
    assert np.array_equal(missing, x)
    assert all(r == reports[0] for r in reports), reports
    report = reports[0]
    assert report["repaired"] and not report["unrecoverable"], report
    assert [os.path.basename(f) for _, f in report["bad"]] == [
        "block_0_0.npy"]
    assert after["ok"], after


def test_collective_delete(mesh_pool, tmp_path):
    flags, left = mesh_pool.run(_delete_case, str(tmp_path))
    assert flags == [(True, False)] * 4
    assert left == []


def test_s3_through_a_shared_fake(mesh_pool, jax_mesh, tmp_path,
                                  monkeypatch):
    import nums_tpu as jnt

    fake = str(tmp_path / "fake_s3")
    monkeypatch.setenv("NUMS_TPU_FAKE_S3_DIR", fake)
    jax_mesh.fs._s3_client().create_bucket("bkt")
    x13 = _values((13, 3))
    ref = _values((6, 5), seed=2)
    jnt.write(jax_mesh.array(ref, block_shape=(3, 5)), "s3://bkt/ref")
    jnt.write(jax_mesh.array(ref, block_shape=(3, 5)), "s3://bkt/gone")
    back, ref_back, keys, after = mesh_pool.run(_s3_case, fake)
    assert np.array_equal(back, x13) and np.array_equal(ref_back, ref)
    assert [k for k in keys if k.startswith("port_")] == [
        "port_0_0", "port_1_0", "port_2_0", "port_3_0", "port_meta"]
    assert not [k for k in after if k.startswith("gone")]
    assert np.array_equal(np.asarray(jnt.read("s3://bkt/port").get()), x13)


def _write_table(tmp_path):
    rs = np.random.RandomState(5)
    x = np.round(rs.randn(37, 4), 6)
    csv = tmp_path / "data.csv"
    with open(csv, "w") as f:
        f.write("a,b,c,d\n")
        for row in x:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\n")  # a trailing blank line is no row
    return x, str(csv)


def test_read_csv_and_parquet_each_rank_its_rows(mesh_pool, jax_mesh,
                                                 tmp_path):
    import nums_tpu as jnt

    x, csv = _write_table(tmp_path)
    want = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
    try:
        import pandas as pd
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq_path = str(tmp_path / "data.parquet")
        pq.write_table(pa.Table.from_pandas(
            pd.DataFrame(want, columns=list("abcd")), preserve_index=False),
            pq_path, row_group_size=8)
    except ImportError:
        pq_path = None
    out = mesh_pool.run(_csv_case, csv, pq_path)
    assert out["csv"].shape == want.shape
    assert np.array_equal(out["csv"], want)
    assert np.array_equal(out["csv"], np.asarray(
        jnt.read_csv(csv, has_header=True).get()))
    # 37 rows in blocks of 9 over 4 ranks: 10/10/10/7, each parsed alone.
    assert out["csv_rows"] == [[10], [10], [10], [7]]
    if pq_path is not None:
        assert np.array_equal(out["parquet"], want)
        # Row groups of 8: rank r decodes group 0 (the width) and the
        # groups that overlap its rows.
        assert out["parquet_groups"] == [[0, 1], [0, 1, 2], [0, 2, 3],
                                         [0, 3, 4]]
        assert [r[0] for r in out["parquet_rows"]] == [10, 10, 10, 7]


def _parquet_out_case(root, pq_path):
    import nums_tpu_torch as ntt

    app = mesh_app()
    x = _values((37, 4))
    ntt.api.write_parquet(app.array(x, block_shape=(10, 4)),
                          os.path.join(root, "from_block_array.parquet"),
                          row_group_rows=8)
    dX = ntt.api.read_parquet(pq_path, out=os.path.join(root, "ingested"),
                              block_rows=5)
    ntt.api.write_parquet(dX, os.path.join(root, "from_disk.parquet"))
    return _gather(np.concatenate([dX.row_panel(i) for i in
                                   range(dX.num_row_panels)]))


def test_parquet_writes_and_ingest_are_collective(mesh_pool, tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    x = _values((37, 4))
    src = str(tmp_path / "src.parquet")
    pq.write_table(pa.table({f"c{j}": x[:, j] for j in range(4)}), src,
                   row_group_size=8)
    seen = mesh_pool.run(_parquet_out_case, str(tmp_path), src)
    assert all(np.array_equal(v, x) for v in seen)  # every rank opened it
    for name in ("from_block_array.parquet", "from_disk.parquet"):
        got = pq.read_table(str(tmp_path / name)).to_pandas().to_numpy()
        assert np.array_equal(got, x), name
    assert pq.ParquetFile(str(
        tmp_path / "from_block_array.parquet")).num_row_groups == 5
    assert not [e for e in os.listdir(tmp_path) if "failed" in e]


def _steps_and_frames_case(root):
    import pandas as pd

    from nums_tpu_torch.core.io import checkpoint
    from nums_tpu_torch.experimental.nums_modin import from_pandas

    app = mesh_app()
    x = _values((13, 3))
    name = os.path.join(root, "steps")
    done = [checkpoint.save_async(app.array(x + s, block_shape=(4, 3)),
                                  name, s).done() for s in range(3)]
    step, back = checkpoint.restore_latest(name)
    frame = from_pandas(pd.DataFrame(x))
    return (done, step, back.get(), checkpoint.steps(name), frame.get(),
            _gather(tuple(frame.raw.to_local().shape)))


def test_step_checkpoints_and_frames(mesh_pool, tmp_path):
    pytest.importorskip("pandas")
    done, step, back, steps, frame, locals_ = mesh_pool.run(
        _steps_and_frames_case, str(tmp_path))
    x = _values((13, 3))
    assert done == [True] * 3  # saved before save_async returned
    assert step == 2 and steps == [1, 2]
    assert np.array_equal(back, x + 2)
    assert np.array_equal(frame, x)
    assert sum(s[0] for s in locals_) >= 13
