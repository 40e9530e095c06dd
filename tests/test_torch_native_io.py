"""nums_tpu_torch's native host engines against nums_tpu's, on the CPU:
the CSV parser (``core/io/_native.py`` on ``csrc/csv_parser.cpp``) and the
block I/O engine (``core/io/shard_native.py`` on ``csrc/shard_io.cpp``).

Every comparison is exact. The parsers are the same C++ and agree bit for
bit, on what they accept and on what they decline; natively written block
files are byte-equal to ``np.save``'s; a window read equals the slice; a
checkpoint written with the engine and one written without it are
byte-equal directories, and each package reads the other's.
"""

import os
import pickle
import re

import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as st

from torch_parity import jax_app, torch_app  # noqa: F401

from nums_tpu_torch.core.io import _native as tnative
from nums_tpu_torch.core.io import shard_native as tshard
from nums_tpu_torch.core.ops import _build


@pytest.fixture(scope="module")
def jnative():
    from nums_tpu.core.io import _native

    assert _native.get_lib() is not None, "nums_tpu's parser did not build"
    return _native


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries of the port build here (g++): no test below may
    pass on the numpy route alone."""
    assert tnative.get_lib() is not None and tshard.get_lib() is not None


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _parse_both(jnative, data, delim=","):
    got, ok = tnative.parse_bytes(data, delim)
    ref, rok = jnative.parse_bytes(data, delim)
    assert ok == rok, (data[:80], ok, rok)
    if ok:
        assert got.shape == ref.shape and _bits(got) == _bits(ref)
    return got, ok


def test_libraries_carry_a_hash_of_their_source():
    names = sorted(os.listdir(_build.BUILD_DIR))
    for stem in ("libnums_csv_", "libnums_shard_"):
        assert any(re.fullmatch(stem + r"[0-9a-f]{16}\.so", n)
                   for n in names), names
    again = _build.host_library("csv_parser.cpp", "nums_csv")
    assert again is not None and again.exists()


def test_sources_are_nums_tpu_s_but_for_comments():
    """The C++ is nums_tpu's own, byte for byte once comments are gone."""
    import nums_tpu.core.io as jio

    def code(path):
        text = open(path).read()
        text = re.sub(r"//[^\n]*", "", text)
        return [ln.rstrip() for ln in text.splitlines() if ln.strip()]

    for name in ("csv_parser.cpp", "shard_io.cpp"):
        ref = os.path.join(os.path.dirname(jio.__file__), name)
        assert code(_build.CSRC_DIR / name) == code(ref), name


def test_no_compiler_gives_none(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(_build, "host_compilers", lambda: [])
    for module in (tnative, tshard):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_tried", False)
        assert module.get_lib() is None
        assert module.get_lib() is None  # tried once, not again
    assert tnative.parse_bytes(b"1,2\n", ",") == (None, False)
    assert tnative.parse_bytes_into(
        b"1,2\n", ",", np.empty(2)) == (0, 0, 0, False)
    assert not tshard.write_shards([(str(tmp_path / "a.npy"), np.ones(3))])
    assert not tshard.read_block_windows(
        [(str(tmp_path / "a.npy"), (slice(0, 3),), (slice(0, 3),))],
        np.empty(3))


def test_an_unwritable_build_directory_gives_none(monkeypatch, tmp_path):
    (tmp_path / "file").write_text("not a directory")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "file" / "build")
    assert _build.host_library("csv_parser.cpp", "nums_csv") is None


def test_a_failing_compiler_falls_through_to_the_next(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    real = _build.host_compilers()
    monkeypatch.setattr(
        _build, "host_compilers",
        lambda: [["/nonexistent/c++"], ["false"]] + real)
    so = _build.host_library("csv_parser.cpp", "nums_csv")
    assert so is not None and so.parent == tmp_path / "b"
    assert [p.name for p in so.parent.iterdir()] == [so.name]  # no tmp left


@pytest.mark.parametrize("data,count", [
    (b"", 0), (b"1,2\n3,4", 4), (b"1,2\n3,4\n", 4), (b"\n\n", 2),
    (b"1,2,\n", 3), (b"7", 1),
])
def test_count_values(jnative, data, count):
    assert tnative.count_values(data, ",") == count
    assert jnative.count_values(data, ",") == count


@pytest.mark.parametrize("data", [
    b"1,2\n3\n", b"1,2\n3,4,5\n", b"a,b\n", b"1,,2\n3,4,5\n", b"1;2\n",
    b"1,2\n3,x\n", b"--1,2\n",
], ids=repr)
def test_declined_texts(jnative, data):
    got, ok = _parse_both(jnative, data)
    assert got is None and not ok


def test_empty_input_and_small_buffer(jnative):
    for native in (tnative, jnative):
        assert native.parse_bytes(b"", ",") == (None, False)
        assert native.parse_bytes_into(
            b"", ",", np.empty(4)) == (0, 0, 0, False)
        # A buffer too small for the text is refused, not overrun.
        out = np.full(3, -1.0)
        assert native.parse_bytes_into(
            b"1,2\n3,4\n", ",", out[:2]) == (0, 0, 0, False)
        assert out[2] == -1.0


def test_random_text_bit_for_bit(jnative):
    rs = np.random.RandomState(0)
    for fmt in ("%.17g", "%.9g", "%.3f", "%e", "%d"):
        vals = rs.randn(257, 9) * 10.0 ** rs.randint(-30, 30, size=(257, 9))
        if fmt == "%d":
            vals = rs.randint(-10**9, 10**9, size=(257, 9))
        text = "\n".join(",".join(fmt % v for v in row) for row in vals)
        got, ok = _parse_both(jnative, text.encode() + b"\n")
        assert ok and got.shape == (257, 9)
        want = np.array([[float(fmt % v) for v in row] for row in vals])
        assert _bits(got) == _bits(want)


_NUMBER = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.floats(allow_nan=False, allow_infinity=False,
              width=32).map(lambda v: "%.9g" % v),
    st.integers(-10**25, 10**25).map(str),
    st.from_regex(r"[+-]?[0-9]{1,25}\.[0-9]{0,25}([eE][+-]?[0-9]{1,3})?",
                  fullmatch=True),
    st.from_regex(r"[+-]?\.[0-9]{1,20}", fullmatch=True),
    st.sampled_from(["inf", "-inf", "nan", "+inf", "Infinity", "1e400",
                     "-1e-400", "0x10", "1e", "1e+", "1.5e3x"]),
)


@hsettings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.lists(st.lists(_NUMBER, min_size=3, max_size=3), min_size=1,
                max_size=6),
       st.sampled_from(["\n", "\r\n", "\n\n"]), st.booleans())
def test_number_formats_bit_for_bit(rows, newline, final_newline):
    """Every number format the parser may meet: the two packages agree bit
    for bit on what parses and decline the same texts, and a field that
    Python's float() reads parses to that double."""
    from nums_tpu.core.io import _native as jnative

    text = newline.join(",".join(r) for r in rows)
    if final_newline:
        text += newline
    got, ok = _parse_both(jnative, text.encode())
    if not ok:
        return
    assert got.shape == (len(rows), 3)
    for r, row in enumerate(rows):
        for c, field in enumerate(row):
            try:
                want = float(field)
            except ValueError:
                continue  # hex and the like: strtod's reading, not float's
            assert _bits(got[r, c]) == _bits(np.float64(want)), field


def test_more_than_two_to_the_31_bytes_fit_the_c_types():
    """The C interface takes ``long`` sizes: 8 bytes on this platform, so
    a range or a block over 2 GB does not wrap."""
    import ctypes

    assert ctypes.sizeof(ctypes.c_long) == 8
    lib = tnative.get_lib()
    assert lib.nums_parse_csv.restype is ctypes.c_long
    assert lib.nums_parse_csv.argtypes[1] is ctypes.c_long


# -- the block engine ------------------------------------------------------

ARRAYS = [
    pytest.param(lambda rs: rs.randn(5, 3), id="f64-2d"),
    pytest.param(lambda rs: np.arange(7, dtype=np.int32), id="i32-1d"),
    pytest.param(lambda rs: rs.randn(2, 2).astype(np.float32), id="f32-2d"),
    pytest.param(lambda rs: np.zeros((0, 4)), id="no-rows"),
    pytest.param(lambda rs: np.asfortranarray(rs.randn(4, 6)), id="fortran"),
    pytest.param(lambda rs: rs.randn(6, 8)[::2, 1:5], id="strided"),
    pytest.param(lambda rs: np.array([2.5]), id="one-value"),
    pytest.param(lambda rs: rs.randn(3, 4, 5), id="3d"),
    pytest.param(lambda rs: rs.rand(9) > 0.5, id="bool"),
]


@pytest.mark.parametrize("make", ARRAYS)
def test_write_shards_bytes_equal_np_save(tmp_path, make):
    """A C-ordered copy is what both routes store: ``write_fs`` hands the
    engine C-ordered blocks, and np.save of that copy is the yardstick."""
    a = make(np.random.RandomState(0))
    pn, pp = str(tmp_path / "native.npy"), str(tmp_path / "numpy.npy")
    assert tshard.write_shards([(pn, a)])
    np.save(pp, np.ascontiguousarray(a))
    assert open(pn, "rb").read() == open(pp, "rb").read()
    back = np.load(pn)
    assert back.dtype == a.dtype and np.array_equal(back, a)


def test_write_shards_many_files_and_threads(tmp_path):
    rs = np.random.RandomState(1)
    items = [(str(tmp_path / f"b{i}.npy"), rs.randn(i + 1, 3))
             for i in range(40)]
    assert tshard.write_shards(items, threads=7)
    for p, a in items:
        assert np.array_equal(np.load(p), a)


def test_write_shards_declines(tmp_path):
    assert not tshard.write_shards([])
    obj = np.array([{"a": 1}, None], dtype=object)
    assert not tshard.write_shards([(str(tmp_path / "o.npy"), obj)])
    assert not os.path.exists(tmp_path / "o.npy")
    # A directory that does not exist: the write fails, and says so.
    assert not tshard.write_shards(
        [(str(tmp_path / "missing" / "a.npy"), np.ones(3))])


def test_npy_layout(tmp_path):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "a.npy")
    np.save(p, a)
    off, shape, fortran, dtype = tshard.npy_layout(p)
    assert (shape, fortran, dtype) == ((3, 4), False, np.dtype(np.float32))
    assert off == os.path.getsize(p) - a.nbytes
    np.save(p, np.asfortranarray(a))
    assert tshard.npy_layout(p)[2] is True
    with open(p, "wb") as f:
        f.write(b"not an npy file")
    assert tshard.npy_layout(p) is None
    assert tshard.npy_layout(str(tmp_path / "missing.npy")) is None


WINDOWS_2D = [
    # (block shape, src window, out shape, dst window)
    ((6, 8), (slice(1, 4), slice(2, 7)), (7, 5), (slice(0, 3), slice(0, 5))),
    ((6, 8), (slice(2, 6), slice(0, 5)), (7, 5), (slice(3, 7), slice(0, 5))),
    ((6, 8), (slice(0, 6), slice(0, 8)), (6, 8), (slice(0, 6), slice(0, 8))),
    ((6, 8), (slice(2, 5), slice(0, 8)), (9, 8), (slice(4, 7), slice(0, 8))),
    ((6, 8), (slice(0, 6), slice(0, 8)), (6, 12), (slice(0, 6), slice(4, 12))),
    ((6, 8), (slice(0, 6), slice(3, 4)), (6, 1), (slice(0, 6), slice(0, 1))),
    ((1, 8), (slice(0, 1), slice(0, 8)), (3, 8), (slice(2, 3), slice(0, 8))),
]


@pytest.mark.parametrize("block,src,out_shape,dst", WINDOWS_2D)
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16])
def test_read_block_windows_2d(tmp_path, block, src, out_shape, dst, dtype):
    """Windows of part of the rows, of whole rows (read in one piece) and
    of whole rows into a wider ``out`` equal the slices."""
    b = (np.random.RandomState(2).randn(*block) * 100).astype(dtype)
    p = str(tmp_path / "b.npy")
    np.save(p, b)
    out = np.full(out_shape, -7, dtype=dtype)
    assert tshard.read_block_windows([(p, src, dst)], out)
    want = np.full(out_shape, -7, dtype=dtype)
    want[dst] = b[src]
    assert np.array_equal(out, want)


def test_read_block_windows_1d_and_many_jobs(tmp_path):
    v = np.arange(100, dtype=np.float64)
    p = str(tmp_path / "v.npy")
    assert tshard.write_shards([(p, v)])
    out = np.zeros(30)
    jobs = [(p, (slice(40 + 10 * i, 50 + 10 * i),),
             (slice(10 * i, 10 * i + 10),)) for i in range(3)]
    assert tshard.read_block_windows(jobs, out, threads=2)
    assert np.array_equal(out, v[40:70])


def test_read_block_windows_declines(tmp_path):
    """Another dtype or rank, Fortran order, an object array, a missing or
    a cut-off file: refused (False), never read as wrong bytes."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "a.npy")
    np.save(p, a)
    whole = (slice(0, 3), slice(0, 4))
    assert not tshard.read_block_windows([(p, whole, whole)],
                                         np.zeros((3, 4)))
    assert not tshard.read_block_windows(
        [(p, (slice(0, 12),), (slice(0, 12),))], np.zeros(12, np.float32))
    out = np.zeros((3, 4), np.float32)
    assert not tshard.read_block_windows([], out)
    assert not tshard.read_block_windows([(p, whole, whole)],
                                         np.asfortranarray(out))
    assert not tshard.read_block_windows(
        [(str(tmp_path / "missing.npy"), whole, whole)], out)
    np.save(p, np.asfortranarray(a))
    assert not tshard.read_block_windows([(p, whole, whole)], out)
    np.save(p, a)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 8)
    assert not tshard.read_block_windows([(p, whole, whole)], out)
    po = str(tmp_path / "o.npy")
    np.save(po, np.array([[None]], dtype=object), allow_pickle=True)
    assert not tshard.read_block_windows(
        [(po, (slice(0, 1), slice(0, 1)), (slice(0, 1), slice(0, 1)))],
        np.zeros((1, 1), dtype=object))


# -- write_fs / read_fs on the engine --------------------------------------

CHECKPOINTS = [
    pytest.param((103, 6), (25, 4), np.float32, id="ragged-2d-f32"),
    pytest.param((64, 12), (16, 12), np.float64, id="row-blocks-f64"),
    pytest.param((103,), (25,), np.float64, id="ragged-1d"),
    pytest.param((7, 5), (3, 2), np.int64, id="2d-int64"),
    pytest.param((), (), np.float64, id="0d"),
    pytest.param((40, 3), (1, 3), np.float32, id="forty-blocks"),
]


def _value(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "i":
        return rs.randint(-50, 50, size=shape).astype(dtype)
    return np.asarray(rs.randn(*shape)).astype(dtype)


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture()
def engine_calls(monkeypatch):
    """How often each function of the engine did the work (returned
    True) since the fixture was set up."""
    calls = {"write": 0, "read": 0}
    for key, name in (("write", "write_shards"),
                      ("read", "read_block_windows")):
        orig = getattr(tshard, name)

        def wrapper(*args, _orig=orig, _key=key, **kwargs):
            ok = _orig(*args, **kwargs)
            calls[_key] += bool(ok)
            return ok

        monkeypatch.setattr(tshard, name, wrapper)
    return calls


@pytest.mark.parametrize("shape,block,dtype", CHECKPOINTS)
def test_native_and_numpy_checkpoints_are_byte_equal(
        torch_app, tmp_path, monkeypatch, engine_calls, shape, block, dtype):
    x = _value(shape, dtype)
    ba = torch_app.array(x, block_shape=block)
    pn, pp = str(tmp_path / "native"), str(tmp_path / "numpy")
    torch_app.write_fs(ba, pn)
    blocks = int(np.prod(ba.grid.grid_shape))
    assert engine_calls["write"] == -(-blocks // 16)  # batches of 16
    back = torch_app.read_fs(pn)
    # A 0-d array has no window to read: its one block loads whole.
    assert engine_calls["read"] == (1 if len(shape) else 0)
    assert back.dtype == x.dtype and back.block_shape == tuple(block)
    assert np.array_equal(back.get(), x)
    assert np.array_equal(torch_app.read_fs(pn, verify=True).get(), x)
    assert engine_calls["read"] == (1 if len(shape) else 0)  # verify: numpy

    monkeypatch.setattr(tshard, "get_lib", lambda: None)
    before = dict(engine_calls)
    torch_app.write_fs(ba, pp)
    assert np.array_equal(torch_app.read_fs(pp).get(), x)
    assert engine_calls == before
    assert _files(pn) == _files(pp)
    # Each route reads the other's files.
    assert np.array_equal(torch_app.read_fs(pn).get(), x)


@pytest.mark.parametrize("shape,block,dtype", CHECKPOINTS)
@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_native_checkpoint_moves_between_the_packages(
        jax_app, torch_app, tmp_path, engine_calls, shape, block, dtype,
        writer):
    from nums_tpu.core.io import shard_native as jshard

    assert jshard.get_lib() is not None
    x = _value(shape, dtype, seed=3)
    p = str(tmp_path / "arr")
    if writer == "nums_tpu":
        jax_app.write_fs(jax_app.array(x, block_shape=block), p)
        back = torch_app.read_fs(p)
        assert engine_calls["read"] == (1 if len(shape) else 0)
    else:
        torch_app.write_fs(torch_app.array(x, block_shape=block), p)
        assert engine_calls["write"] >= 1
        back = jax_app.read_fs(p)
    got = np.asarray(back.get())
    assert got.dtype == x.dtype and np.array_equal(got, x)
    assert tuple(back.block_shape) == tuple(block)
    other = str(tmp_path / "other")
    if writer == "nums_tpu":
        torch_app.write_fs(torch_app.array(x, block_shape=block), other)
    else:
        jax_app.write_fs(jax_app.array(x, block_shape=block), other)
    fa, fb = _files(p), _files(other)
    assert pickle.loads(fa.pop("meta.pkl")) == pickle.loads(fb.pop("meta.pkl"))
    assert fa == fb


def test_replicas_are_written_by_the_engine(torch_app, tmp_path,
                                            engine_calls):
    x = _value((20, 4), np.float32, seed=4)
    p = str(tmp_path / "arr")
    torch_app.write_fs(torch_app.array(x, block_shape=(5, 4)), p, replicas=3)
    assert engine_calls["write"] == 1
    for d in (p, p + ".replica1", p + ".replica2"):
        assert _files(d) == _files(p)
    assert torch_app.verify_fs(p)["ok"]


def test_a_torn_block_falls_back_to_the_replicas(torch_app, tmp_path,
                                                 engine_calls):
    """A block the engine cannot read sends the whole read to the checked
    route, which fails over block by block."""
    x = _value((20, 4), np.float32, seed=5)
    p = str(tmp_path / "arr")
    torch_app.write_fs(torch_app.array(x, block_shape=(5, 4)), p, replicas=2)
    victim = os.path.join(p, "block_2_0.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 4)
    assert np.array_equal(torch_app.read_fs(p).get(), x)
    assert engine_calls["read"] == 0
    os.remove(victim)
    assert np.array_equal(torch_app.read_fs(p).get(), x)
