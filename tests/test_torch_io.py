"""nums_tpu_torch's local-disk I/O against nums_tpu's, on the CPU: block
checkpoints (write_fs/read_fs/verify_fs/delete_fs, replicas, recovery of
a torn publish), the top-level verbs, step checkpoints, the models'
persistence helpers and GLM.save/GLM.load.

The format on disk is the same, so each comparison is exact: the two
packages write equal ``meta.pkl`` contents and byte-equal block files for
the same array, each reads the other's checkpoints bit for bit, and their
scrub reports, journals and restored steps are equal. A GLM saved by one
package predicts in the other as in its own, to 1e-12 of the largest
prediction (float64; only the order of the sums in X @ beta differs) and
with equal labels.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from torch_parity import jax_app, rel_err, torch_app  # noqa: F401

import nums_tpu_torch
from nums_tpu_torch.core import settings
from nums_tpu_torch.core.io import checkpoint as tcheckpoint
from nums_tpu_torch.core.io import filesystem as tfilesystem
from nums_tpu_torch.models import _common as tcommon
from nums_tpu_torch.models import glms as tglms

PRED_REL = 1e-12


def _files(path):
    """{file name: bytes} of a checkpoint directory."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _block_path(root, entry):
    return os.path.join(root, "block_" + "_".join(map(str, entry)) + ".npy")


CASES = [
    pytest.param((103, 6), (25, 6), np.float64, id="ragged-2d-f64"),
    pytest.param((103, 6), (25, 4), np.float32, id="ragged-2d-f32"),
    pytest.param((103,), (25,), np.float64, id="ragged-1d-f64"),
    pytest.param((40,), (40,), np.float32, id="1d-f32-one-block"),
    pytest.param((7, 5), (3, 2), np.int64, id="2d-int64"),
    pytest.param((), (), np.float64, id="0d"),
]


def _value(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "i":
        return rs.randint(-50, 50, size=shape).astype(dtype)
    return np.asarray(rs.randn(*shape)).astype(dtype)


@pytest.mark.parametrize("shape,block,dtype", CASES)
def test_write_read_exists_delete_roundtrip(torch_app, tmp_path, shape,
                                            block, dtype):
    x = _value(shape, dtype)
    p = str(tmp_path / "arr")
    fs = torch_app.fs
    assert not fs.exists_fs(p)
    ok = torch_app.write_fs(torch_app.array(x, block_shape=block), p)
    assert ok.dtype == bool and ok.all()
    assert fs.exists_fs(p)
    back = torch_app.read_fs(p)
    assert back.dtype == x.dtype and back.block_shape == tuple(block)
    assert np.array_equal(back.get(), x)
    assert np.array_equal(torch_app.read_fs(p, verify=True).get(), x)
    assert torch_app.delete_fs(p).tolist() == [True]
    assert not fs.exists_fs(p) and not os.path.exists(p)
    assert torch_app.delete_fs(p).tolist() == [False]


@pytest.mark.parametrize("shape,block,dtype", CASES)
def test_same_files_as_nums_tpu(jax_app, torch_app, tmp_path, shape, block,
                                dtype):
    """The same array gives equal meta.pkl contents and byte-equal block
    files in both packages."""
    x = _value(shape, dtype, seed=1)
    pt, pj = str(tmp_path / "t"), str(tmp_path / "j")
    torch_app.write_fs(torch_app.array(x, block_shape=block), pt)
    jax_app.write_fs(jax_app.array(x, block_shape=block), pj)
    ft, fj = _files(pt), _files(pj)
    assert sorted(ft) == sorted(fj)
    assert pickle.loads(ft.pop("meta.pkl")) == pickle.loads(fj.pop("meta.pkl"))
    assert ft == fj


@pytest.mark.parametrize("shape,block,dtype", CASES)
@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_checkpoint_reads_in_the_other_package(jax_app, torch_app, tmp_path,
                                               shape, block, dtype, writer):
    x = _value(shape, dtype, seed=2)
    p = str(tmp_path / "arr")
    if writer == "nums_tpu":
        jax_app.write_fs(jax_app.array(x, block_shape=block), p)
        back = torch_app.read_fs(p, verify=True)
    else:
        torch_app.write_fs(torch_app.array(x, block_shape=block), p)
        back = jax_app.read_fs(p, verify=True)
    got = np.asarray(back.get())
    assert got.dtype == x.dtype and np.array_equal(got, x)
    assert tuple(back.block_shape) == tuple(block)


def test_lost_primary_block_fails_over_to_replica(torch_app, tmp_path):
    p = str(tmp_path / "arr")
    x = np.arange(24, dtype=float).reshape(6, 4)
    torch_app.write_fs(torch_app.array(x, block_shape=(3, 2)), p,
                       replicas=2)
    assert os.path.isfile(os.path.join(p + ".replica1", "meta.pkl"))
    os.remove(_block_path(p, (1, 1)))
    assert np.array_equal(torch_app.read_fs(p).get(), x)
    # A torn primary meta.pkl fails over too.
    os.remove(os.path.join(p, "meta.pkl"))
    assert np.array_equal(torch_app.read_fs(p, verify=True).get(), x)
    torch_app.delete_fs(p)
    assert not os.path.isdir(p + ".replica1")


def test_overwrite_drops_stale_replicas(torch_app, tmp_path):
    p = str(tmp_path / "arr")
    x = np.arange(8, dtype=float)
    torch_app.write_fs(torch_app.array(x, block_shape=(4,)), p, replicas=3)
    assert os.path.isdir(p + ".replica2")
    torch_app.write_fs(torch_app.array(x * 10, block_shape=(4,)), p)
    assert not os.path.isdir(p + ".replica1")
    assert not os.path.isdir(p + ".replica2")
    assert np.array_equal(torch_app.read_fs(p).get(), x * 10)


def test_replica_roots_mirror_the_full_path(torch_app, tmp_path,
                                            monkeypatch):
    """Replicas under configured roots mirror the whole path, so two
    checkpoints with one base name never share a replica."""
    roots = [str(tmp_path / "r1"), str(tmp_path / "r2")]
    monkeypatch.setattr(settings, "replica_roots", roots)
    a, b = str(tmp_path / "a" / "step_0"), str(tmp_path / "b" / "step_0")
    xa, xb = np.arange(6.0), -np.arange(6.0)
    torch_app.write_fs(torch_app.array(xa, block_shape=(3,)), a, replicas=3)
    torch_app.write_fs(torch_app.array(xb, block_shape=(3,)), b, replicas=3)
    reps = tfilesystem._existing_replicas(a)
    assert len(reps) == 2 and all(r.startswith(tuple(roots)) for r in reps)
    os.remove(_block_path(a, (0,)))
    os.remove(_block_path(reps[0], (0,)))
    assert np.array_equal(torch_app.read_fs(a).get(), xa)
    assert np.array_equal(torch_app.read_fs(b).get(), xb)
    torch_app.delete_fs(a)
    assert tfilesystem._existing_replicas(a) == []
    assert len(tfilesystem._existing_replicas(b)) == 2


def _report(report, root):
    """A verify_fs report with its directories relative to ``root``."""
    rel = {k: v for k, v in report.items()}
    for key in ("bad", "repaired"):
        rel[key] = sorted((os.path.relpath(d, root), f) for d, f in report[key])
    return rel


def test_verify_reports_and_repairs_as_nums_tpu(jax_app, torch_app,
                                                tmp_path):
    """The same silent corruption gives the same scrub report in both
    packages; repair heals it; every copy corrupt gives the same error."""
    rs = np.random.RandomState(0)
    x = rs.randn(8, 4)
    reports = {}
    for name, app in (("j", jax_app), ("t", torch_app)):
        root = str(tmp_path / name)
        p = os.path.join(root, "arr")
        app.write_fs(app.array(x, block_shape=(4, 4)), p, replicas=2)
        np.save(_block_path(p, (1, 0)), np.ones((4, 4)))
        np.save(_block_path(p + ".replica1", (0, 0)), np.ones((4, 4)))
        first = app.verify_fs(p)
        assert np.array_equal(np.asarray(app.read_fs(p, verify=True).get()),
                              x)
        repair = app.verify_fs(p, repair=True)
        after = app.verify_fs(p)
        assert np.array_equal(np.asarray(app.read_fs(p).get()), x)
        for d in (p, p + ".replica1"):
            np.save(_block_path(d, (0, 0)), np.zeros((4, 4)))
        lost = app.verify_fs(p, repair=True)
        with pytest.raises(Exception) as err:
            app.read_fs(p, verify=True).get()
        reports[name] = [_report(r, root)
                         for r in (first, repair, after, lost)] + [
            (type(err.value), str(err.value))]
    assert reports["t"] == reports["j"]
    first, repair, after, lost, (etype, _) = reports["t"]
    assert not first["ok"] and first["bad"] == [
        ("arr", "block_1_0.npy"), ("arr.replica1", "block_0_0.npy")]
    assert repair["repaired"] == first["bad"] and after["ok"]
    assert lost["unrecoverable"] == ["block_0_0.npy"]
    assert etype is IOError or issubclass(etype, OSError)


def test_torn_publish_is_promoted(torch_app, tmp_path):
    """A crash between the two publish renames (the final directory gone,
    a complete .tmp and .old left): readers promote the newest complete
    tmp, the version that was being published."""
    p = str(tmp_path / "arr")
    x1 = np.arange(8, dtype=float)
    torch_app.write_fs(torch_app.array(x1, block_shape=(4,)), p)
    staging = str(tmp_path / "staging")
    torch_app.write_fs(torch_app.array(x1 * 7, block_shape=(4,)), staging)
    os.rename(p, p + ".old-111")
    os.rename(staging, p + ".tmp-222")
    assert torch_app.fs.exists_fs(p)
    assert np.array_equal(torch_app.read_fs(p).get(), x1 * 7)
    torch_app.delete_fs(p)
    assert not torch_app.fs.exists_fs(p)
    assert not os.path.isdir(p + ".old-111")


def test_orphans_cleaned_but_live_writer_kept(torch_app, tmp_path):
    """A write sweeps the orphans of crashed writers (the multi-process
    writers' .tmp-0 too) and leaves a live writer's .tmp-<pid>."""
    import subprocess
    import sys

    p = str(tmp_path / "arr")
    dead = p + ".tmp-0"
    os.makedirs(dead)
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        live = p + f".tmp-{proc.pid}"
        os.makedirs(live)
        torch_app.write_fs(torch_app.array(np.arange(4.0),
                                           block_shape=(2,)), p)
        assert not os.path.isdir(dead)
        assert os.path.isdir(live)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_api_verbs(torch_app, tmp_path, monkeypatch):
    x = np.arange(12.0).reshape(3, 4)
    p = str(tmp_path / "api")
    assert nums_tpu_torch.write(torch_app.array(x, block_shape=(2, 4)),
                                p).all()
    assert np.array_equal(nums_tpu_torch.read(p).get(), x)
    assert nums_tpu_torch.delete(p).tolist() == [True]
    # An s3:// name goes to S3 (tests/test_torch_s3.py): with no boto3
    # and no fake asked for, each verb says so.
    monkeypatch.setattr(tfilesystem.FileSystem, "s3_client_factory", None)
    monkeypatch.delenv("NUMS_TPU_TORCH_FAKE_S3_DIR", raising=False)
    monkeypatch.delenv("NUMS_TPU_TORCH_FAKE_S3", raising=False)
    monkeypatch.setitem(sys.modules, "boto3", None)  # not importable
    with pytest.raises(RuntimeError, match="boto3"):
        nums_tpu_torch.read("s3://bucket/key")
    with pytest.raises(RuntimeError, match="boto3"):
        nums_tpu_torch.write(torch_app.array(x), "s3://bucket/key")
    with pytest.raises(RuntimeError, match="boto3"):
        nums_tpu_torch.delete("s3://bucket/key")


def test_relative_names_live_under_data_dir(torch_app, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(settings, "data_dir", str(tmp_path / "data"))
    x = np.arange(5.0)
    torch_app.write_fs(torch_app.array(x, block_shape=(5,)), "rel")
    assert os.path.isfile(tmp_path / "data" / "rel" / "meta.pkl")
    assert np.array_equal(torch_app.read_fs("rel").get(), x)


def _checkpoint_run(checkpoint, app, name):
    """One sequence of step checkpoints: two replicated saves (the second
    prunes the first), a corrupted block that a verified restore routes
    around, two async saves, and a torn step promoted on the walk."""
    rs = np.random.RandomState(2)
    a = [rs.randn(6, 3) for _ in range(4)]
    checkpoint.save(app.array(a[0], block_shape=(3, 3)), name, step=0,
                    replicas=2)
    checkpoint.save(app.array(a[1], block_shape=(3, 3)), name, step=1,
                    keep=1, replicas=2)
    np.save(_block_path(os.path.join(name, "step_1"), (0, 0)),
            np.zeros((3, 3)))
    step, back = checkpoint.restore_latest(name, verify=True)
    out = {"steps_1": checkpoint.steps(name), "restored_1": step,
           "value_1": np.asarray(back.get())}
    futs = [checkpoint.save_async(app.array(a[k], block_shape=(2, 3)), name,
                                  step=k, keep=3) for k in (2, 3)]
    assert [f.result(timeout=60) for f in futs] == [2, 3]
    checkpoint.wait_pending()
    step3 = os.path.join(name, "step_3")
    os.rename(step3, step3 + ".old-99")
    out["steps_2"] = checkpoint.steps(name)
    out["resume"] = checkpoint.resume_step(name)
    step, back = checkpoint.restore_latest(name)
    out["restored_2"], out["value_2"] = step, np.asarray(back.get())
    out["events"] = [(e, s) for _, e, s in checkpoint.journal(name)]
    with open(os.path.join(name, "journal.log"), "a") as f:
        f.write("123.0 comm")  # a torn last line
    out["events_torn"] = [(e, s) for _, e, s in checkpoint.journal(name)]
    checkpoint.delete(name)
    out["after_delete"] = (checkpoint.steps(name), checkpoint.resume_step(
        name, default=-1))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_latest(name)
    return out, a


def test_step_checkpoints_as_nums_tpu(jax_app, torch_app, tmp_path):
    from nums_tpu.core.io import checkpoint as jcheckpoint

    got, a = _checkpoint_run(tcheckpoint, torch_app, str(tmp_path / "t"))
    ref, _ = _checkpoint_run(jcheckpoint, jax_app, str(tmp_path / "j"))
    for key in ref:
        if key.startswith("value"):
            assert np.array_equal(got[key], ref[key]), key
        else:
            assert got[key] == ref[key], key
    assert got["restored_1"] == 1 and np.array_equal(got["value_1"], a[1])
    assert got["restored_2"] == 3 and np.array_equal(got["value_2"], a[3])
    assert ("prune", 0) in got["events"] and ("restore", 1) in got["events"]


@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_save_model_arrays_loads_in_both(jax_app, torch_app, tmp_path,
                                         writer):
    from nums_tpu.models import _common as jcommon

    meta = {"model": "PCA", "n_components": 2, "whiten": False}
    w = np.random.RandomState(3).randn(4, 2)
    p = str(tmp_path / "m")
    if writer == "nums_tpu":
        jcommon.save_model_arrays(p, meta, {"w": jax_app.array(w),
                                            "mean": np.ones(4), "skip": None})
    else:
        tcommon.save_model_arrays(p, meta, {"w": torch_app.array(w),
                                            "mean": np.ones(4), "skip": None})
    # Saving again publishes over the first version.
    tcommon.save_model_arrays(p, meta, {"w": w, "mean": np.ones(4)})
    for load in (jcommon.load_model_arrays, tcommon.load_model_arrays):
        got_meta, arrays = load(p)
        assert got_meta == meta and sorted(arrays) == ["mean", "w"]
        assert np.array_equal(arrays["w"], w)
    assert not [e for e in os.listdir(tmp_path) if e != "m"]


# -- GLM.save / GLM.load ------------------------------------------------

N, D = 64, 3
GLM_CLASSES = ["LinearRegression", "LogisticRegression", "PoissonRegression",
               "ExponentialRegression", "Ridge", "Lasso", "ElasticNet"]


def _glm_data(name):
    rs = np.random.RandomState(5)
    X = rs.randn(N, D)
    eta = X @ np.array([0.5, -0.3, 0.2]) + 0.1
    if name == "LogisticRegression":
        y = (rs.rand(N) < 1.0 / (1.0 + np.exp(-eta))).astype(float)
    elif name == "PoissonRegression":
        y = rs.poisson(np.exp(eta)).astype(float)
    elif name == "ExponentialRegression":
        y = np.exp(eta) * rs.exponential(size=N)
    else:
        y = eta + 0.1 * rs.randn(N)
    return X, y


def _glm(glms, name):
    cls = getattr(glms, name)
    if name in ("Ridge", "Lasso", "ElasticNet"):
        return cls(alpha=0.1, tol=1e-8, max_iter=200)
    kw = {"penalty": "l2", "C": 2.0} if name == "LogisticRegression" else {}
    return cls(solver="newton", tol=1e-8, max_iter=20, **kw)


def _fit(glms, app, name):
    X, y = _glm_data(name)
    bx = app.array(X, block_shape=(16, D))
    return _glm(glms, name).fit(bx, app.array(y, block_shape=(16,))), bx


def _predict(model, X):
    return np.asarray(model.predict(X).get())


def _same_model(a, b):
    assert type(a).__name__ == type(b).__name__
    assert np.array_equal(np.asarray(a.coef_.get()), np.asarray(b.coef_.get()))
    assert float(a.intercept_.get()) == float(b.intercept_.get())
    for attr in ("_penalty", "_tol", "_max_iter", "_opt", "_lr",
                 "_admm_rho", "_l1_ratio"):
        assert getattr(a, attr) == getattr(b, attr), attr
    # λ is stored as C = 1/λ and restored as 1/C: one rounding each way.
    assert a._lambda == pytest.approx(b._lambda, rel=1e-15)
    la, lb = a._lambda_vec, b._lambda_vec
    assert (la is None) == (lb is None)
    if la is not None:
        assert np.array_equal(np.asarray(la.get()), np.asarray(lb.get()))


@pytest.mark.parametrize("name", GLM_CLASSES)
def test_glm_save_load_roundtrip(torch_app, tmp_path, name):
    model, bx = _fit(tglms, torch_app, name)
    p = str(tmp_path / "model")
    model.save(p)
    back = tglms.GLM.load(p)
    _same_model(back, model)
    assert np.array_equal(_predict(back, bx), _predict(model, bx))


@pytest.mark.parametrize("name", GLM_CLASSES)
@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_glm_saved_by_one_package_loads_in_the_other(jax_app, torch_app,
                                                     tmp_path, name, writer):
    from nums_tpu.models import glms as jglms

    p = str(tmp_path / "model")
    X, _ = _glm_data(name)
    if writer == "nums_tpu":
        saved, _ = _fit(jglms, jax_app, name)
        saved.save(p)
        loaded = tglms.GLM.load(p)
        ref, got = _predict(saved, jax_app.array(X)), _predict(
            loaded, torch_app.array(X))
    else:
        saved, _ = _fit(tglms, torch_app, name)
        saved.save(p)
        loaded = jglms.GLM.load(p)
        ref, got = _predict(saved, torch_app.array(X)), _predict(
            loaded, jax_app.array(X))
    _same_model(loaded, saved)
    if name == "LogisticRegression":
        assert np.array_equal(got, ref)
    else:
        assert rel_err(got, ref) <= PRED_REL
