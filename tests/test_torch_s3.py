"""nums_tpu_torch's S3 path against nums_tpu's, on the CPU, through the
fake clients of each package (neither boto3 nor a network here).

An array in S3 is one pickled numpy block per object plus the pickled
grid, the same objects in both packages, so every comparison is exact:
each package reads what the other wrote bit for bit, from one fake
directory that both share, and the stored objects are equal bytes.
"""

import pickle

import numpy as np
import pytest

from torch_parity import jax_app, torch_app  # noqa: F401

import nums_tpu_torch
from nums_tpu_torch.core.io import fake_s3
from nums_tpu_torch.core.io.fake_s3 import (
    FakeS3Client, FileBackedFakeS3Client, NoSuchBucket, NoSuchKey,
)
from nums_tpu_torch.core.io.filesystem import FileSystem, _s3_parse

BUCKET = "darrays"


@pytest.fixture()
def memory_s3(monkeypatch):
    """The in-process fake, asked for through the environment."""
    monkeypatch.setattr(FileSystem, "s3_client_factory", None)
    monkeypatch.delenv("NUMS_TPU_TORCH_FAKE_S3_DIR", raising=False)
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3", "1")
    FakeS3Client.reset()
    client = FakeS3Client()
    client.create_bucket(Bucket=BUCKET)
    yield client
    FakeS3Client.reset()


@pytest.fixture()
def shared_s3(monkeypatch, tmp_path):
    """One fake directory that both packages see as their S3."""
    from nums_tpu.core.io.filesystem import FileSystem as JFileSystem

    root = str(tmp_path / "cloud")
    monkeypatch.setattr(FileSystem, "s3_client_factory", None)
    monkeypatch.setattr(JFileSystem, "s3_client_factory", None)
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3_DIR", root)
    monkeypatch.setenv("NUMS_TPU_FAKE_S3_DIR", root)
    client = FileBackedFakeS3Client(root)
    client.create_bucket(Bucket=BUCKET)
    return client


CASES = [
    pytest.param((16, 8), (4, 8), np.float64, id="even-2d"),
    pytest.param((1003, 7), (126, 7), np.float32, id="ragged-rows"),
    pytest.param((103, 6), (25, 4), np.float64, id="ragged-2d"),
    pytest.param((103,), (25,), np.float32, id="ragged-1d"),
    pytest.param((7, 5), (3, 2), np.int64, id="int64"),
    pytest.param((), (), np.float64, id="0d"),
]


def _value(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "i":
        return rs.randint(-50, 50, size=shape).astype(dtype)
    return np.asarray(rs.randn(*shape)).astype(dtype)


def _keys(client, prefix=""):
    listing = client.list_objects_v2(Bucket=BUCKET, Prefix=prefix)
    assert listing["KeyCount"] == len(listing["Contents"])
    return [c["Key"] for c in listing["Contents"]]


@pytest.mark.parametrize("make", [
    lambda tmp: FakeS3Client(),
    lambda tmp: FileBackedFakeS3Client(str(tmp / "cloud")),
], ids=["memory", "files"])
def test_fake_client_semantics(tmp_path, make):
    FakeS3Client.reset()
    c = make(tmp_path)
    with pytest.raises(NoSuchBucket):
        c.put_object(Bucket="nope", Key="k", Body=b"x")
    c.create_bucket(Bucket="b")
    c.put_object(Bucket="b", Key="a/k1", Body=b"abc")
    c.put_object(Bucket="b", Key="a/k#2", Body="text")
    assert c.get_object(Bucket="b", Key="a/k1")["Body"].read() == b"abc"
    assert c.get_object(Bucket="b", Key="a/k#2")["Body"].read() == b"text"
    with pytest.raises(NoSuchKey):
        c.get_object(Bucket="b", Key="missing")
    assert isinstance(NoSuchKey("k"), c.exceptions.NoSuchKey)
    assert [o["Key"] for o in c.list_objects_v2(
        Bucket="b", Prefix="a/")["Contents"]] == ["a/k#2", "a/k1"]
    assert c.list_objects_v2(Bucket="b", Prefix="z")["KeyCount"] == 0
    out = c.delete_objects(Bucket="b", Delete={
        "Objects": [{"Key": "a/k1"}, {"Key": "missing"}]})
    assert out["Deleted"] == [{"Key": "a/k1"}]
    c.delete_object(Bucket="b", Key="a/k#2")
    c.delete_object(Bucket="b", Key="a/k#2")  # idempotent
    assert c.list_objects_v2(Bucket="b")["KeyCount"] == 0
    c.reset()
    with pytest.raises(NoSuchBucket):
        c.list_objects_v2(Bucket="b")


def test_file_backed_fake_is_shared_and_atomic(tmp_path):
    """Two clients on one directory see one store; a put leaves no
    temporary file in a listing."""
    a = FileBackedFakeS3Client(str(tmp_path / "cloud"))
    b = FileBackedFakeS3Client(str(tmp_path / "cloud"))
    a.create_bucket(Bucket="b")
    a.put_object(Bucket="b", Key="x/y z", Body=b"1")
    assert b.get_object(Bucket="b", Key="x/y z")["Body"].read() == b"1"
    (tmp_path / "cloud" / "b" / "#tmp-1-orphan").write_bytes(b"torn")
    assert [o["Key"] for o in b.list_objects_v2(Bucket="b")["Contents"]] == [
        "x/y z"]


def test_s3_parse():
    assert _s3_parse("bucket/a/b/c") == ("bucket", "a/b/c")
    assert _s3_parse("bucket") == ("bucket", "")
    with pytest.raises(AssertionError):
        _s3_parse("s3://bucket/key")


@pytest.mark.parametrize("shape,block,dtype", CASES)
def test_write_read_delete(torch_app, memory_s3, shape, block, dtype):
    x = _value(shape, dtype)
    bx = torch_app.array(x, block_shape=block)
    ok = torch_app.write_s3(bx, f"{BUCKET}/foo/arr")
    blocks = int(np.prod(bx.grid.grid_shape))
    assert ok.dtype == bool and ok.shape == (blocks,) and ok.all()
    keys = _keys(memory_s3, "foo/")
    assert len(keys) == blocks + 1 and "foo/arr_meta" in keys
    assert torch_app.fs.read_meta_s3(f"{BUCKET}/foo/arr") == {
        "grid": bx.grid.to_meta()}
    back = torch_app.read_s3(f"{BUCKET}/foo/arr")
    assert back.dtype == x.dtype and back.block_shape == tuple(block)
    assert np.array_equal(back.get(), x)
    deleted = torch_app.delete_s3(f"{BUCKET}/foo/arr")
    assert deleted.shape == (blocks + 1,) and deleted.all()
    assert _keys(memory_s3) == []
    with pytest.raises(NoSuchKey):
        torch_app.read_s3(f"{BUCKET}/foo/arr")


def test_stored_blocks_are_plain_numpy(torch_app, memory_s3):
    """What nums_tpu can load: a C-ordered ndarray, no torch type; a 0-d
    array's block has shape (1,)."""
    x = _value((6, 4), np.float32, seed=1)
    torch_app.write_s3(torch_app.array(x, block_shape=(4, 4)).T,
                       f"{BUCKET}/t")
    blk = pickle.loads(
        memory_s3.get_object(Bucket=BUCKET, Key="t_0_1")["Body"].read())
    assert type(blk) is np.ndarray and blk.flags.c_contiguous
    assert np.array_equal(blk, x.T[:, 4:])
    torch_app.write_s3(torch_app.scalar(2.5), f"{BUCKET}/s")
    blk = pickle.loads(
        memory_s3.get_object(Bucket=BUCKET, Key="s_")["Body"].read())
    assert blk.shape == (1,) and blk[0] == 2.5


def test_meta_is_written_last(torch_app, memory_s3, monkeypatch):
    """A put that fails on the last block leaves no meta object: a reader
    never sees a grid whose blocks are not all there."""
    x = _value((12, 3), np.float64, seed=2)
    bx = torch_app.array(x, block_shape=(4, 3))
    puts = []
    real_put = FakeS3Client.put_object

    def put(self, Bucket, Key, Body):
        if Key == "arr_2_0":
            raise OSError("connection lost")
        puts.append(Key)
        return real_put(self, Bucket=Bucket, Key=Key, Body=Body)

    monkeypatch.setattr(FakeS3Client, "put_object", put)
    with pytest.raises(OSError):
        torch_app.write_s3(bx, f"{BUCKET}/arr")
    assert puts == ["arr_0_0", "arr_1_0"]
    assert "arr_meta" not in _keys(memory_s3)
    with pytest.raises(NoSuchKey):
        torch_app.read_s3(f"{BUCKET}/arr")
    monkeypatch.setattr(FakeS3Client, "put_object", real_put)
    torch_app.write_s3(bx, f"{BUCKET}/arr")
    assert _keys(memory_s3)[-1] == "arr_meta"
    assert np.array_equal(torch_app.read_s3(f"{BUCKET}/arr").get(), x)


def test_delete_sends_at_most_1000_keys_a_request(torch_app, memory_s3,
                                                  monkeypatch):
    x = np.arange(2100, dtype=np.float32)
    torch_app.write_s3(torch_app.array(x, block_shape=(1,)),
                       f"{BUCKET}/many")
    assert len(_keys(memory_s3)) == 2101
    calls = []
    real = FakeS3Client.delete_objects

    def spy(self, Bucket, Delete):
        calls.append(len(Delete["Objects"]))
        return real(self, Bucket=Bucket, Delete=Delete)

    monkeypatch.setattr(FakeS3Client, "delete_objects", spy)
    out = torch_app.delete_s3(f"{BUCKET}/many")
    assert calls == [1000, 1000, 101] and out.shape == (2101,)
    assert _keys(memory_s3) == []


@pytest.mark.parametrize("shape,block,dtype", CASES)
@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_objects_move_between_the_packages(jax_app, torch_app, shared_s3,
                                           shape, block, dtype, writer):
    x = _value(shape, dtype, seed=3)
    apps = {"nums_tpu": jax_app, "nums_tpu_torch": torch_app}
    other = "nums_tpu_torch" if writer == "nums_tpu" else "nums_tpu"
    w, r = apps[writer], apps[other]
    w.write_s3(w.array(x, block_shape=block), f"{BUCKET}/x/arr")
    back = r.read_s3(f"{BUCKET}/x/arr")
    got = np.asarray(back.get())
    assert got.dtype == x.dtype and np.array_equal(got, x)
    assert tuple(back.block_shape) == tuple(block)
    # The same array written by the reader's package: equal objects.
    r.write_s3(r.array(x, block_shape=block), f"{BUCKET}/y/arr")
    mine = {k[2:]: shared_s3.get_object(Bucket=BUCKET, Key=k)["Body"].read()
            for k in _keys(shared_s3, "x/")}
    theirs = {k[2:]: shared_s3.get_object(Bucket=BUCKET, Key=k)["Body"].read()
              for k in _keys(shared_s3, "y/")}
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        a, b = pickle.loads(mine[k]), pickle.loads(theirs[k])
        if k.endswith("_meta"):
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    r.delete_s3(f"{BUCKET}/x/arr")
    w.delete_s3(f"{BUCKET}/y/arr")
    assert _keys(shared_s3) == []


def test_package_verbs_dispatch_on_the_scheme(torch_app, shared_s3,
                                              tmp_path):
    """``read``/``write``/``delete`` send ``s3://`` names to S3 and any
    other name to the filesystem."""
    x = _value((15, 4), np.float32, seed=4)
    bx = torch_app.array(x, block_shape=(4, 4))
    assert nums_tpu_torch.write(bx, f"s3://{BUCKET}/v/arr").all()
    assert len(_keys(shared_s3, "v/")) == 5
    back = nums_tpu_torch.read(f"s3://{BUCKET}/v/arr")
    assert back.block_shape == (4, 4) and np.array_equal(back.get(), x)
    assert nums_tpu_torch.delete(f"s3://{BUCKET}/v/arr").all()
    assert _keys(shared_s3) == []
    local = str(tmp_path / "arr")
    nums_tpu_torch.write(bx, local)
    assert np.array_equal(nums_tpu_torch.read(local).get(), x)
    assert nums_tpu_torch.delete(local).tolist() == [True]
    assert _keys(shared_s3) == []


def test_client_selection(torch_app, monkeypatch, tmp_path):
    """The factory first, then the fake directory, then the in-process
    fake, then boto3; without any of them a RuntimeError that says how to
    get a fake."""
    import sys

    fs = torch_app.fs
    monkeypatch.setattr(FileSystem, "s3_client_factory", None)
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3", "1")
    assert type(fs._s3_client()) is FileBackedFakeS3Client
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3_DIR", "")
    assert type(fs._s3_client()) is FakeS3Client
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3", "0")
    monkeypatch.setitem(sys.modules, "boto3", None)  # not importable
    with pytest.raises(RuntimeError, match="NUMS_TPU_TORCH_FAKE_S3=1"):
        fs._s3_client()
    with pytest.raises(RuntimeError):
        nums_tpu_torch.read("s3://bucket/key")

    class Boto3:
        @staticmethod
        def client(name):
            return ("a boto3 client", name)

    monkeypatch.setitem(sys.modules, "boto3", Boto3)
    assert fs._s3_client() == ("a boto3 client", "s3")
    # A fake that was asked for outranks an importable boto3.
    monkeypatch.setenv("NUMS_TPU_TORCH_FAKE_S3", "1")
    assert type(fs._s3_client()) is FakeS3Client
    sentinel = object()
    monkeypatch.setattr(FileSystem, "s3_client_factory",
                        staticmethod(lambda: sentinel))
    assert fs._s3_client() is sentinel


def test_module_names_nums_tpu_s_classes():
    """The port's own copy, with the reference's names."""
    import nums_tpu.core.io.fake_s3 as jfake

    for name in ("FakeS3Client", "FileBackedFakeS3Client", "NoSuchKey",
                 "NoSuchBucket"):
        assert getattr(fake_s3, name) is not getattr(jfake, name)
        assert getattr(fake_s3, name).__module__ == fake_s3.__name__
