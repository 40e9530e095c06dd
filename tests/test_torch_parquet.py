"""nums_tpu_torch's Parquet verbs and DataFrame bridge against nums_tpu's,
on the CPU (needs pyarrow and pandas; the machine with the card has
neither, so nothing else holds this path).

Parquet stores the columns' bits, so every comparison is exact: each
package reads the other's files to equal arrays in equal block shapes, a
DiskArray streamed from a file has block files byte-equal to nums_tpu's,
and the files written have equal row groups and columns.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pq = pytest.importorskip("pyarrow.parquet")
pd = pytest.importorskip("pandas")
import pyarrow as pa  # noqa: E402

from torch_parity import jax_app, torch_app  # noqa: E402,F401

import nums_tpu  # noqa: E402
import nums_tpu_torch  # noqa: E402
from nums_tpu_torch import api as tapi  # noqa: E402
from nums_tpu_torch.core.array.diskarray import DiskArray  # noqa: E402
from nums_tpu_torch.experimental import nums_modin as tmodin  # noqa: E402


def _table_file(tmp_path, data, group_rows, name="t.parquet"):
    table = pa.table({f"c{i}": data[:, i] for i in range(data.shape[1])})
    p = str(tmp_path / name)
    pq.write_table(table, p, row_group_size=group_rows)
    return p


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(columns=["c1", "c3"]), dict(dtype=np.float32),
    dict(columns=["c4", "c0"], dtype=np.float32), dict(block_rows=40),
    dict(block_rows=1000), dict(block_rows=7, columns=["c2"]),
], ids=lambda kw: "-".join(kw) or "default")
def test_read_parquet_matches_nums_tpu(jax_app, torch_app, tmp_path, kw):
    data = np.random.RandomState(0).randn(1000, 5)
    p = _table_file(tmp_path, data, 256)  # 4 row groups, the last ragged
    ref = nums_tpu.read_parquet(p, **kw)
    got = nums_tpu_torch.read_parquet(p, **kw)
    cols = [int(c[1:]) for c in kw.get("columns", [f"c{i}" for i in range(5)])]
    want = data[:, cols].astype(kw.get("dtype", np.float64))
    assert got.shape == ref.shape == want.shape
    assert got.dtype == ref.dtype == want.dtype
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    if "block_rows" in kw:
        assert got.block_shape[0] == kw["block_rows"]
    assert np.array_equal(got.get(), want)
    assert np.array_equal(got.get(), np.asarray(ref.get()))


def test_read_parquet_mixed_column_types(jax_app, torch_app, tmp_path):
    """Integer and float columns decode to one float64 array, as pandas
    makes it, in both packages."""
    table = pa.table({"i": np.arange(50, dtype=np.int32),
                      "f": np.linspace(0.0, 1.0, 50)})
    p = str(tmp_path / "m.parquet")
    pq.write_table(table, p, row_group_size=20)
    ref, got = nums_tpu.read_parquet(p), nums_tpu_torch.read_parquet(p)
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got.get(), np.asarray(ref.get()))


@pytest.mark.parametrize("block_rows,group_rows", [
    (150, 100), (100, 100), (64, 300), (None, 100), (777, 50), (1, 400),
])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_read_parquet_to_a_disk_array(jax_app, torch_app, tmp_path,
                                      block_rows, group_rows, dtype):
    """``out=`` streams the row groups to a DiskArray: the same blocks,
    byte for byte, as nums_tpu's, and a checkpoint that scrubs clean."""
    if block_rows == 1:
        data = np.random.RandomState(1).randn(40, 3)
    else:
        data = np.random.RandomState(1).randn(777, 4)
    p = _table_file(tmp_path, data, group_rows)
    kw = dict(block_rows=block_rows, dtype=dtype)
    ref = nums_tpu.read_parquet(p, out=str(tmp_path / "j"), **kw)
    got = nums_tpu_torch.read_parquet(p, out=str(tmp_path / "t"), **kw)
    assert isinstance(got, DiskArray)
    want = data.astype(dtype or np.float64)
    assert got.shape == ref.shape == want.shape
    assert got.dtype == ref.dtype == want.dtype
    assert np.array_equal(got.to_block_array().get(), want)
    assert torch_app.verify_fs(got.path)["ok"]
    ft, fj = _files(got.path), _files(ref.path)
    assert pickle.loads(ft.pop("meta.pkl")) == pickle.loads(fj.pop("meta.pkl"))
    assert ft == fj
    rows = block_rows or min(group_rows, data.shape[0])
    assert len(ft) == -(-data.shape[0] // rows)


def test_read_parquet_refuses_bad_block_rows(torch_app, tmp_path):
    p = _table_file(tmp_path, np.ones((10, 2)), 5)
    with pytest.raises(AssertionError):
        nums_tpu_torch.read_parquet(p, out=str(tmp_path / "x"), block_rows=0)
    with pytest.raises(AssertionError):
        nums_tpu_torch.read_parquet(p, block_rows=-1)
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("sizes,rows", [
    ([100, 100, 100], 100), ([100, 100, 100], 150), ([7, 300, 1, 92], 64),
    ([5, 5], 100), ([50], 7), ([3, 4, 5], 1), ([10, 0, 10], 8),
])
def test_rechunk_matches_nums_tpu(sizes, rows):
    from nums_tpu.api import _rechunk as jrechunk

    rs = np.random.RandomState(2)
    panels = [rs.randn(n, 3) for n in sizes]
    got = list(tapi._rechunk(iter(panels), rows))
    ref = list(jrechunk(iter(panels), rows))
    whole = np.concatenate(panels)
    assert [p.shape for p in got] == [p.shape for p in ref]
    assert all(p.shape[0] == rows for p in got[:-1])
    assert 0 < got[-1].shape[0] <= rows
    assert np.array_equal(np.concatenate(got), whole)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_rechunk_refuses_zero_rows():
    with pytest.raises(AssertionError):
        list(tapi._rechunk(iter([np.ones((2, 2))]), 0))


def _groups(path):
    meta = pq.ParquetFile(path).metadata
    return [meta.row_group(i).num_rows for i in range(meta.num_row_groups)]


@pytest.mark.parametrize("kw,groups", [
    (dict(), [100, 100, 100]),
    (dict(column_names=["a", "b", "c"]), [100, 100, 100]),
    (dict(row_group_rows=125), [125, 125, 50]),
    (dict(row_group_rows=1000), [300]),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else None)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_parquet_from_a_block_array(jax_app, torch_app, tmp_path, kw,
                                          groups, dtype):
    data = np.random.RandomState(3).randn(300, 3).astype(dtype)
    pt, pj = str(tmp_path / "t.parquet"), str(tmp_path / "j.parquet")
    nums_tpu_torch.write_parquet(
        torch_app.array(data, block_shape=(100, 3)), pt, **kw)
    nums_tpu.write_parquet(jax_app.array(data, block_shape=(100, 3)), pj,
                           **kw)
    assert _groups(pt) == _groups(pj) == groups
    tt, tj = pq.read_table(pt), pq.read_table(pj)
    assert tt.equals(tj) and tt.schema.equals(tj.schema)
    assert tt.column_names == list(kw.get("column_names",
                                          ["c0", "c1", "c2"]))
    # Each package reads the other's file.
    got, ref = nums_tpu_torch.read_parquet(pj), nums_tpu.read_parquet(pt)
    assert got.dtype == dtype and np.array_equal(got.get(), data)
    assert np.array_equal(np.asarray(ref.get()), data)
    assert tuple(got.block_shape) == tuple(ref.block_shape)


def test_write_parquet_of_a_transposed_array(torch_app, tmp_path):
    data = np.random.RandomState(4).randn(4, 60)
    p = str(tmp_path / "t.parquet")
    nums_tpu_torch.write_parquet(
        torch_app.array(data, block_shape=(4, 25)).T, p)
    assert _groups(p) == [25, 25, 10]
    assert np.array_equal(nums_tpu_torch.read_parquet(p).get(), data.T)


@pytest.mark.parametrize("row_group_rows,groups", [
    (None, [60, 60]), (25, [25, 25, 25, 25, 20]), (60, [60, 60]),
    (500, [120]),
])
def test_write_parquet_from_a_disk_array(jax_app, torch_app, tmp_path,
                                         row_group_rows, groups):
    data = np.random.RandomState(5).randn(120, 3)
    dt = torch_app.spill(torch_app.array(data, block_shape=(60, 3)),
                         str(tmp_path / "dt"))
    dj = jax_app.spill(jax_app.array(data, block_shape=(60, 3)),
                       str(tmp_path / "dj"))
    pt, pj = str(tmp_path / "t.parquet"), str(tmp_path / "j.parquet")
    nums_tpu_torch.write_parquet(dt, pt, row_group_rows=row_group_rows)
    nums_tpu.write_parquet(dj, pj, row_group_rows=row_group_rows)
    assert _groups(pt) == _groups(pj) == groups
    assert pq.read_table(pt).equals(pq.read_table(pj))
    assert np.array_equal(nums_tpu_torch.read_parquet(pt).get(), data)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_zero_rows_still_write_a_valid_file(jax_app, torch_app, tmp_path,
                                            dtype):
    pt, pj = str(tmp_path / "t.parquet"), str(tmp_path / "j.parquet")
    empty = np.empty((0, 2), dtype)
    nums_tpu_torch.write_parquet(
        torch_app.array(empty, block_shape=(1, 2)), pt,
        column_names=["a", "b"])
    nums_tpu.write_parquet(jax_app.array(empty, block_shape=(1, 2)), pj,
                           column_names=["a", "b"])
    tt, tj = pq.read_table(pt), pq.read_table(pj)
    assert tt.num_rows == 0 and tt.column_names == ["a", "b"]
    assert tt.schema.equals(tj.schema)


def test_write_parquet_refuses_bad_arguments(torch_app, tmp_path):
    p = str(tmp_path / "x.parquet")
    ba = torch_app.array(np.ones((4, 2)), block_shape=(2, 2))
    with pytest.raises(AssertionError):
        nums_tpu_torch.write_parquet(ba, p, column_names=["only-one"])
    with pytest.raises(AssertionError):
        nums_tpu_torch.write_parquet(ba, p, row_group_rows=0)
    with pytest.raises(AssertionError):
        nums_tpu_torch.write_parquet(
            torch_app.array(np.ones(4), block_shape=(2,)), p)
    assert not os.path.exists(p)


def test_a_failed_write_closes_the_file(torch_app, tmp_path, monkeypatch):
    """The writer is closed when a stripe fails, and the error is the
    stripe's."""
    closed = []
    real = pq.ParquetWriter

    class Writer(real):
        def write_table(self, table, *a, **k):
            if getattr(self, "_wrote", False):  # the second stripe
                raise OSError("disk full")
            self._wrote = True
            return super().write_table(table, *a, **k)

        def close(self):
            closed.append(True)
            return super().close()

    monkeypatch.setattr(pq, "ParquetWriter", Writer)
    ba = torch_app.array(np.ones((6, 2)), block_shape=(2, 2))
    with pytest.raises(OSError, match="disk full"):
        nums_tpu_torch.write_parquet(ba, str(tmp_path / "x.parquet"))
    assert closed == [True]


# -- the DataFrame bridge --------------------------------------------------

@pytest.mark.parametrize("case", ["frame", "series", "dtype", "object",
                                  "ints"])
def test_from_pandas_matches_nums_tpu(jax_app, torch_app, case):
    from nums_tpu.experimental import nums_modin as jmodin

    rs = np.random.RandomState(6)
    kw = {}
    if case == "frame":
        df = pd.DataFrame(rs.randn(200, 4), columns=list("abcd"))
    elif case == "series":
        df = pd.Series(rs.randn(50), name="s")
    elif case == "dtype":
        df, kw = pd.DataFrame(rs.randn(30, 3)), dict(dtype=np.float32)
    elif case == "object":
        df = pd.DataFrame({"a": [1, 2, 3], "b": [0.5, None, 2.5]},
                          dtype=object)
    else:
        df = pd.DataFrame(rs.randint(0, 9, size=(20, 2)))
    ref = jmodin.from_pandas(df, **kw)
    got = tmodin.from_pandas(df, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert np.array_equal(got.get(), np.asarray(ref.get()), equal_nan=True)


@pytest.mark.parametrize("block_shape", [None, (37, 3)])
def test_from_row_parts_matches_nums_tpu(jax_app, torch_app, block_shape):
    from nums_tpu.experimental import nums_modin as jmodin

    rs = np.random.RandomState(7)
    parts = [rs.randn(n, 3).astype(t) for n, t in
             ((10, np.float32), (1, np.float64), (64, np.float32), (25, int))]
    ref = jmodin._from_row_parts(parts, block_shape=block_shape)
    got = tmodin._from_row_parts(parts, block_shape=block_shape)
    assert got.shape == ref.shape == (100, 3)
    assert got.dtype == ref.dtype == np.float64
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert np.array_equal(got.get(), np.concatenate(parts))
    assert np.array_equal(got.get(), np.asarray(ref.get()))


def test_from_modin_needs_modin(torch_app):
    try:
        import modin  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="modin is not available"):
            tmodin.from_modin(pd.DataFrame({"a": [1.0]}))
    else:  # where modin is installed, the frame converts
        import modin.pandas as mpd

        got = tmodin.from_modin(mpd.DataFrame({"a": [1.0, 2.0]}))
        assert np.array_equal(got.get(), [[1.0], [2.0]])


def test_package_import_loads_no_optional_dependency():
    """``import nums_tpu_torch`` and its I/O modules import neither
    pyarrow, pandas nor boto3: they load inside the functions that need
    them."""
    probe = (
        "import sys\n"
        "import nums_tpu_torch, nums_tpu_torch.api\n"
        "import nums_tpu_torch.core.io.filesystem\n"
        "import nums_tpu_torch.experimental.nums_modin\n"
        "bad = [m for m in ('pyarrow', 'pandas', 'boto3', 'modin')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert nums_tpu_torch.read_parquet and nums_tpu_torch.write_parquet\n"
        "assert nums_tpu_torch.read_csv\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=repo,
        env={**os.environ, "PYTHONPATH": repo, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
