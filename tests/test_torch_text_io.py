"""nums_tpu_torch's text ingestion against nums_tpu's, on the CPU:
``read_csv``, ``read_csv_host`` and ``loadtxt`` on the same files, and the
HIGGS pipeline (CSV -> split -> Newton logistic fit -> accuracy) as a
whole at 4000 x 9.

Both packages parse with the same C++ parser and the same ``np.loadtxt``
route, in float64 on the CPU, so every comparison of ingested arrays is
exact (``np.array_equal`` with nan equal to nan) and the block shapes are
equal; a text that one package refuses the other refuses with the same
exception. The pipeline's fit is held to the tolerances
``tests/test_torch_glm.py`` uses for the same fit: plain float32 on both
sides to 1e-5 of max|beta| with equal labels and accuracy; the kernel
route (the port's plain versions of its kernels, nums_tpu's Pallas kernels
in interpret mode) to 1e-2 of max|beta|, labels agreeing on 98% of the
rows.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    jax_app, padded_jax_app, rel_err, torch_app,
)

import nums_tpu_torch
from nums_tpu_torch.core import settings
from nums_tpu_torch.core.io import _native as tnative

WORKERS = [1, 2, 4, 6, 5000]  # the last: more workers than lines or bytes


def _outcome(fn):
    """("ok", array) or ("raises", exception type)."""
    try:
        return "ok", np.asarray(fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return "raises", type(e)


def _same(got, ref):
    assert got[0] == ref[0], (got, ref)
    if got[0] == "raises":
        assert got[1] is ref[1], (got, ref)
        return
    assert got[1].dtype == ref[1].dtype and got[1].shape == ref[1].shape
    assert np.array_equal(got[1], ref[1], equal_nan=True)


def _rows(n, d, seed, fmt="%.17g"):
    rs = np.random.RandomState(seed)
    arr = rs.randn(n, d)
    return arr, [",".join(fmt % v for v in row) for row in arr]


def _plain():
    return "\n".join(_rows(203, 7, 0)[1]) + "\n"


def _blank_lines_no_final_newline():
    lines = _rows(97, 5, 1)[1]
    for i in (60, 30, 0):
        lines.insert(i, "")
    return "\n".join(lines)


def _trailing_newlines():
    return "\n".join(_rows(50, 3, 2)[1]) + "\n\n\n"


def _trailing_delimiter():
    return "".join(line + ",\n" for line in _rows(40, 4, 3)[1])


def _crlf():
    return "\r\n".join(_rows(64, 6, 4)[1]) + "\r\n"


def _spaces_after_delimiter():
    return "\n".join(line.replace(",", ", ") for line in _rows(31, 3, 5)[1])


def _nan_inf():
    return "1,inf,3\n-inf,nan,6\n7,-nan,+inf\n"


def _long_mantissas():
    # More than 15 significant digits, exponents outside [-22, 22] and
    # subnormals: the exact fast path declines, strtod decides.
    return ("0.12345678901234567890123,1e-300,4.9e-324\n"
            "123456789012345678901234567890,1e300,-2.2250738585072014e-308\n"
            "1.7976931348623157e308,9007199254740993,1e23\n")


def _hex_fields():
    return "0x1.8p1,2,3\n4,5,6\n"


def _ragged():
    return "1,2,3\n4,5\n6,7,8\n"


def _non_numeric():
    return "1,2,unparseable\n4,5,6\n"


def _integers_and_signs():
    return "+1,-2,3.\n.5,-.25,1e3\n1E-3,-0,0\n"


def _one_line_no_newline():
    return "1.5,2.5,3.5"


def _blank():
    return "\n\n  \n"


TEXTS = {
    "plain": _plain, "blank-lines": _blank_lines_no_final_newline,
    "trailing-newlines": _trailing_newlines,
    "trailing-delimiter": _trailing_delimiter, "crlf": _crlf,
    "spaces": _spaces_after_delimiter, "nan-inf": _nan_inf,
    "long-mantissas": _long_mantissas, "hex": _hex_fields,
    "ragged": _ragged, "non-numeric": _non_numeric,
    "signs": _integers_and_signs, "one-line": _one_line_no_newline,
    "blank": _blank,
}


@pytest.fixture(scope="module")
def text_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("texts")
    out = {}
    for name, make in TEXTS.items():
        path = root / f"{name}.csv"
        path.write_bytes(make().encode())
        out[name] = str(path)
    return out


def test_both_native_parsers_are_built(jax_app, torch_app):
    """The comparisons below go through the native parser of each
    package: a host without a C++ compiler would compare np.loadtxt with
    itself."""
    from nums_tpu.core.io import _native as jnative

    assert tnative.get_lib() is not None and jnative.get_lib() is not None


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_read_csv_host_matches_nums_tpu(jax_app, torch_app, text_files, name,
                                        workers):
    path = text_files[name]
    got = _outcome(lambda: torch_app.fs.read_csv_host(path,
                                                      num_workers=workers))
    ref = _outcome(lambda: jax_app.fs.read_csv_host(path,
                                                    num_workers=workers))
    _same(got, ref)


@pytest.mark.parametrize("name,outcome", [
    ("plain", "ok"), ("blank-lines", "ok"), ("trailing-delimiter", "ok"),
    ("crlf", "ok"), ("nan-inf", "ok"), ("long-mantissas", "ok"),
    ("ragged", ValueError), ("non-numeric", ValueError),
    ("blank", ValueError),
])
def test_read_csv_host_outcomes(torch_app, text_files, name, outcome):
    """What the port itself does with each text, whatever nums_tpu does:
    numeric text parses to what np.loadtxt gives (trailing delimiters
    apart, which np.loadtxt refuses), the rest raises ValueError."""
    path = text_files[name]
    if outcome != "ok":
        with pytest.raises(outcome):
            torch_app.fs.read_csv_host(path, num_workers=3)
        return
    got = torch_app.fs.read_csv_host(path, num_workers=3)
    if name == "trailing-delimiter":
        ref = _rows(40, 4, 3)[0]
    else:
        ref = np.loadtxt(path, delimiter=",", ndmin=2)
    assert got.dtype == np.float64
    assert np.array_equal(got, ref, equal_nan=True)


def test_strtod_fallback_fields_are_correctly_rounded(torch_app, text_files):
    got = torch_app.fs.read_csv_host(text_files["long-mantissas"],
                                     num_workers=1)
    want = [[float(v) for v in line.split(",")]
            for line in _long_mantissas().splitlines()]
    assert np.array_equal(got, np.array(want))
    assert got[0, 2] == 5e-324 and got[2, 1] == 9007199254740992.0


@pytest.mark.parametrize("workers", [1, 4, None])
@pytest.mark.parametrize("header", [False, True])
@pytest.mark.parametrize("dtype", [float, np.float32])
def test_read_csv_matches_nums_tpu(jax_app, torch_app, tmp_path, header,
                                   workers, dtype):
    """The verb of the application and of the package: values, dtype and
    block shape as nums_tpu's."""
    arr, lines = _rows(500, 7, 6)
    path = str(tmp_path / "data.csv")
    with open(path, "w") as f:
        if header:
            f.write("a,b,c,d,e,f,g\n")
        f.write("\n".join(lines) + "\n")
    kw = dict(dtype=dtype, has_header=header, num_workers=workers)
    ref = jax_app.read_csv(path, **kw)
    got = torch_app.read_csv(path, **kw)
    assert got.shape == ref.shape == (500, 7)
    assert got.dtype == ref.dtype == np.dtype(dtype)
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert np.array_equal(got.get(), np.asarray(ref.get()))
    assert np.array_equal(got.get(), arr.astype(dtype))
    top = nums_tpu_torch.read_csv(path, **kw)
    assert top.block_shape == got.block_shape
    assert np.array_equal(top.get(), got.get())


def test_fs_read_csv_blocks_as_nums_tpu(jax_app, torch_app, tmp_path):
    _, lines = _rows(120, 3, 7)
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    ref, got = jax_app.fs.read_csv(path), torch_app.fs.read_csv(path)
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert np.array_equal(got.get(), np.asarray(ref.get()))


def test_other_delimiter(jax_app, torch_app, tmp_path):
    arr, lines = _rows(33, 4, 8)
    path = str(tmp_path / "d.tsv")
    with open(path, "w") as f:
        f.write("\n".join(line.replace(",", ";") for line in lines) + "\n")
    ref = jax_app.fs.read_csv_host(path, delimiter=";", num_workers=3)
    got = torch_app.fs.read_csv_host(path, delimiter=";", num_workers=3)
    assert np.array_equal(got, ref) and np.array_equal(got, arr)


def test_numpy_route_without_the_library(torch_app, text_files, monkeypatch):
    """No compiler: get_lib gives None and every range goes through
    np.loadtxt, to the same array."""
    want = torch_app.fs.read_csv_host(text_files["plain"], num_workers=4)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tnative.parse_bytes(b"1,2\n", ",") == (None, False)
    got = torch_app.fs.read_csv_host(text_files["plain"], num_workers=4)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        torch_app.fs.read_csv_host(text_files["blank"], num_workers=2)


def test_byte_ranges_match_nums_tpu(jax_app, torch_app, text_files):
    for name in ("plain", "blank-lines", "one-line", "blank"):
        for workers in WORKERS:
            assert (torch_app.fs._byte_ranges(text_files[name], workers)
                    == jax_app.fs._byte_ranges(text_files[name], workers))


LOADTXT_TEXTS = {
    "table": "\n".join(" ".join("%.17g" % v for v in row)
                       for row in np.random.RandomState(9).randn(100, 3)),
    "one-row": "1.5 2.5 3.5\n",
    "one-column": "1\n2\n3\n4\n",
    "one-value": "42.5\n",
    "comments": "# head\n1 2\n3 4# tail\n# between\n5 6\n",
}


@pytest.mark.parametrize("workers", [1, 3, None])
@pytest.mark.parametrize("name", sorted(LOADTXT_TEXTS))
def test_loadtxt_simple_matches_nums_tpu_and_numpy(jax_app, torch_app,
                                                   tmp_path, name, workers):
    path = str(tmp_path / "t.txt")
    with open(path, "w") as f:
        f.write(LOADTXT_TEXTS[name])
    kw = dict(comments="#") if name == "comments" else {}
    ref = jax_app.loadtxt(path, num_workers=workers, **kw)
    got = torch_app.loadtxt(path, num_workers=workers, **kw)
    want = np.loadtxt(path, **kw)
    assert got.shape == ref.shape == want.shape
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert got.dtype == ref.dtype == want.dtype
    assert np.array_equal(got.get(), np.asarray(ref.get()))
    assert np.array_equal(got.get(), want)


@pytest.mark.parametrize("kw", [
    dict(skiprows=2), dict(usecols=(0, 2)), dict(unpack=True),
    dict(ndmin=2), dict(max_rows=7), dict(dtype=np.float32),
    dict(converters={1: lambda s: float(s) * 2.0}),
    dict(delimiter=",", usecols=(1,)),
], ids=lambda kw: "-".join(kw))
def test_loadtxt_other_arguments_take_numpy(jax_app, torch_app, tmp_path,
                                            kw):
    rs = np.random.RandomState(10)
    sep = kw.get("delimiter", " ")
    path = str(tmp_path / "t.txt")
    with open(path, "w") as f:
        f.write("\n".join(sep.join("%.17g" % v for v in row)
                          for row in rs.randn(20, 3)) + "\n")
    ref = jax_app.loadtxt(path, **kw)
    got = torch_app.loadtxt(path, **kw)
    want = np.loadtxt(path, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert tuple(got.block_shape) == tuple(ref.block_shape)
    assert np.array_equal(got.get(), want)
    assert np.array_equal(got.get(), np.asarray(ref.get()))


@pytest.mark.parametrize("text", ["", "\n\n"], ids=["empty", "newlines"])
def test_loadtxt_without_rows_raises(jax_app, torch_app, tmp_path, text):
    path = str(tmp_path / "e.txt")
    with open(path, "w") as f:
        f.write(text)
    for app in (jax_app, torch_app):
        with pytest.raises(ValueError):
            app.loadtxt(path)


# -- the slice: CSV -> split -> logistic fit -> accuracy -------------------

HIGGS_N, HIGGS_D = 4000, 8
HIGGS_FIT = dict(solver="newton", tol=1e-8, max_iter=10)


@pytest.fixture(scope="module")
def higgs_csv(tmp_path_factory):
    """A HIGGS-shaped file at 4000 x 9: the label, then float32 features
    written with nine significant digits, labels from a planted beta with
    logistic noise."""
    rs = np.random.RandomState(11)
    X = rs.randn(HIGGS_N, HIGGS_D).astype(np.float32)
    w = 0.5 * rs.randn(HIGGS_D)
    p = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ w)))
    y = (p > rs.rand(HIGGS_N)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("higgs") / "higgs.csv")
    np.savetxt(path, np.concatenate([y[:, None], X], axis=1), fmt="%.9g",
               delimiter=",")
    return path, X, y


def _pipeline(app, glms, block_array, path):
    """scripts/higgs.py's steps in one package: (host array, beta, labels
    predicted on the test rows, accuracy)."""
    host = app.fs.read_csv_host(path, num_workers=4)
    n = host.shape[0]
    X = block_array.from_np(host[:, 1:].astype(np.float32),
                            block_shape=(n, host.shape[1] - 1),
                            backend=app.backend)
    y = app.array(host[:, 0].astype(np.float32), block_shape=(n,))
    split = int(n * 0.8)
    model = glms.LogisticRegression(**HIGGS_FIT).fit(X[:split], y[:split])
    pred = model.predict(X[split:])
    acc = float((pred == y[split:].astype(np.int64)).mean())
    beta = np.append(model._beta.get(), model._beta0.get())
    return host, beta, np.asarray(pred.get()), acc


def _both_pipelines(japp, tapp, path):
    from nums_tpu.core.array.blockarray import BlockArray as JBlockArray
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.models import glms as tglms

    ref = _pipeline(japp, jglms, JBlockArray, path)
    got = _pipeline(tapp, tglms, BlockArray, path)
    return got, ref


def _check_ingest(got, ref, X, y):
    assert got[0].dtype == ref[0].dtype == np.float64
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[0][:, 1:].astype(np.float32), X)
    assert np.array_equal(got[0][:, 0].astype(np.float32), y)


def test_higgs_pipeline_plain_float32(jax_app, torch_app, higgs_csv,
                                      monkeypatch):
    path, X, y = higgs_csv
    monkeypatch.setattr(settings, "matmul_precision", "highest")
    got, ref = _both_pipelines(jax_app, torch_app, path)
    _check_ingest(got, ref, X, y)
    assert rel_err(got[1], ref[1]) < 1e-5
    assert np.array_equal(got[2], ref[2])
    assert got[3] == ref[3] and got[3] > 0.7


def test_higgs_pipeline_kernel_route(padded_jax_app, torch_app, higgs_csv):
    from nums_tpu.core.ops import pallas_newton

    path, X, y = higgs_csv
    assert settings.matmul_precision == "default"
    got, ref = _both_pipelines(padded_jax_app, torch_app, path)
    assert pallas_newton.enabled()
    _check_ingest(got, ref, X, y)
    assert rel_err(got[1], ref[1]) < 1e-2
    assert np.mean(got[2] == ref[2]) >= 0.98
    assert abs(got[3] - ref[3]) <= 0.02 and got[3] > 0.7
