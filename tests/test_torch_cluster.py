"""nums_tpu_torch.models.cluster.KMeans against nums_tpu's on the CPU:
every test of tests/models/test_cluster.py with the same numpy inputs
through both packages, the k-means++ draws, the one-hot sums and
save/load across the packages.

Both packages cast X to float32 (``cluster.py:150``). Tolerances: labels,
``n_iter`` and the k-means++ centers equal to the reference's; centers
and inertia within 1e-5 relative (fp32 sums in another order: the
reference scatter-adds rows, the port multiplies by the one-hot
assignment in float64; the port's inertia sums the differences, the
reference's the expanded distances); the port's sums within 1e-12 of
float64 sums of the same assignment (float64 sums of float32 values in
another order), its inertia within 1e-5 of float64 on clusters far from
the origin; the sums of a split X equal to those of the whole within
1e-12.
"""

import numpy as np
import pytest
import torch

from torch_parity import apps, jax_app, rel_err, torch_app  # noqa: F401

import jax
import jax.numpy as jnp
import jax.random as jr
from nums_tpu.models import cluster as jcluster
from nums_tpu_torch.core.ops import random_ops, threefry
from nums_tpu_torch.models import cluster as tcluster

REL = 1e-5
SUMS_REL = 1e-12


def _blobs(rs, k, n_per, d, spread=8.0):
    centers = rs.randn(k, d) * spread
    X = np.concatenate([c + rs.randn(n_per, d) for c in centers], axis=0)
    y = np.repeat(np.arange(k), n_per)
    perm = rs.permutation(len(X))
    return X[perm], y[perm], centers


def _cluster_accuracy(labels, truth, k):
    acc = 0
    for c in range(k):
        members = truth[labels == c]
        if len(members):
            acc += int((members == np.bincount(members).argmax()).sum())
    return acc / len(truth)


def both_fit(apps, X, block_shape, **kw):
    """(port model, reference model) fitted on the same X."""
    jax_app, torch_app = apps
    return (tcluster.KMeans(**kw).fit(torch_app.array(X, block_shape)),
            jcluster.KMeans(**kw).fit(jax_app.array(X, block_shape)))


def assert_same_model(got, ref, labels=True):
    assert got.n_iter_ == ref.n_iter_
    gc, rc = got.cluster_centers_.get(), ref.cluster_centers_.get()
    assert gc.dtype == rc.dtype == np.float32
    assert rel_err(gc, rc) <= REL
    assert abs(got.inertia_ - ref.inertia_) <= REL * abs(ref.inertia_)
    if labels:
        gl, rl = got.labels_.get(), ref.labels_.get()
        assert gl.dtype == rl.dtype
        assert np.array_equal(gl, rl)


@pytest.mark.parametrize("k,seed", [(2, 0), (4, 3), (7, 11), (16, 1337)])
def test_plusplus_init_picks_the_reference_centers(k, seed):
    """The seeding draws on the reference's keys: the same rows."""
    rs = np.random.RandomState(k)
    x = rs.randn(500, 6).astype(np.float32)
    ref = np.asarray(jcluster._seed_kernel(k)(jnp.asarray(x), jr.key(seed)))
    xt = torch.from_numpy(x)
    got = tcluster._plusplus_init(k, seed, xt, tcluster._row_sq_norms(xt),
                                  True).numpy()
    assert np.array_equal(got, ref)
    first = int(jr.randint(jr.fold_in(jr.key(seed), 0), (), 0, 500))
    assert _first_index(seed, 500, True) == first


def _first_index(seed, n, x64):
    """The port's first k-means++ row: its draw in ``_plusplus_init``."""
    key = threefry.seed_key(seed, x64)
    return int(random_ops.jr_randint(
        threefry.fold_in(key, 0), (), 0, n,
        torch.int64 if x64 else torch.int32, "cpu", x64))


@pytest.mark.parametrize("seed", [0, 1337])
def test_plusplus_first_index_without_x64(seed):
    """The card draws as the reference with x64 off (int32 randint); seed
    0 at 2.5M rows is chip_smoke.py's known answer."""
    with jax.enable_x64(False):
        want = int(jr.randint(jr.fold_in(jr.key(seed), 0), (), 0,
                              2_500_000))
    assert _first_index(seed, 2_500_000, False) == want
    if seed == 0:
        import importlib.util
        import pathlib

        spec = importlib.util.spec_from_file_location(
            "chip_smoke",
            pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        assert want == chip_smoke.KM_FIRST_INDEX


def test_onehot_sums_against_float64(torch_app):
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1500, 9).astype(np.float32) * 10)
    c = x[:5].clone()
    assign, sums, counts = tcluster._assign_stats(x, c, 5)
    a = assign.numpy()
    x64 = x.numpy().astype(np.float64)
    want = np.stack([x64[a == j].sum(axis=0) for j in range(5)])
    assert sums.dtype == torch.float64
    assert rel_err(sums.numpy(), want) <= SUMS_REL
    assert np.array_equal(counts.numpy(), np.bincount(a, minlength=5))
    # Split as a streamed fit splits X into panels: the same sums.
    parts = [tcluster._assign_stats(p, c, 5) for p in torch.split(x, 400)]
    assert rel_err(sum(p[1] for p in parts).numpy(), want) <= SUMS_REL


def test_inertia_against_float64_far_from_the_origin():
    """Planted clusters far from the origin: the inertia from the
    differences stays within 1e-5 of float64, where the expansion's
    ||x||² − 2x·c + ||c||² drifts."""
    rs = np.random.RandomState(4)
    k, d, n = 4, 40, 8000
    planted = (100.0 * rs.randn(k, d)).astype(np.float32)
    lab = rs.randint(0, k, n)
    x = torch.from_numpy((rs.randn(n, d) + planted[lab]).astype(np.float32))
    c = torch.from_numpy(planted)
    assign = torch.from_numpy(lab)
    x64, c64 = x.numpy().astype(np.float64), planted.astype(np.float64)
    want = float(((x64 - c64[lab]) ** 2).sum())
    got = float(tcluster._inertia(x, c, assign))
    assert abs(got - want) <= REL * want
    expansion = float(tcluster._dists2(x, c).gather(
        1, assign[:, None]).sum())
    assert abs(expansion - want) > 10 * abs(got - want)


def test_empty_cluster_keeps_its_center():
    centers = torch.tensor([[0.0, 0.0], [5.0, 5.0], [9.0, 9.0]])
    sums = torch.tensor([[2.0, 2.0], [0.0, 0.0], [27.0, 27.0]])
    counts = torch.tensor([2.0, 0.0, 3.0])
    new, shift = tcluster._update(centers, sums, counts)
    assert torch.equal(new, torch.tensor([[1.0, 1.0], [5.0, 5.0],
                                          [9.0, 9.0]]))
    assert float(shift) == pytest.approx(np.sqrt(2.0))


def test_kmeans_recovers_blobs(apps):
    rs = np.random.RandomState(0)
    X, y, _ = _blobs(rs, k=4, n_per=300, d=5)
    got, ref = both_fit(apps, X, (300, 5), n_clusters=4, seed=3)
    assert_same_model(got, ref)
    labels = got.labels_.get()
    assert _cluster_accuracy(labels, y, 4) > 0.97
    assert got.cluster_centers_.shape == (4, 5)
    assert got.inertia_ > 0 and got.n_iter_ >= 1
    bX = apps[1].array(X, block_shape=(300, 5))
    assert np.array_equal(got.predict(bX).get(), labels)
    assert np.array_equal(got.fit_predict(bX).get(), labels)


@pytest.mark.parametrize("max_iter,tol", [(1, 1e-4), (3, 0.0), (100, 1e-4)])
def test_kmeans_stop_test_and_iterations(apps, max_iter, tol):
    """Overlapping blobs take several Lloyd iterations: the same count
    and centers as the reference under each stop."""
    rs = np.random.RandomState(12)
    X, _, _ = _blobs(rs, k=5, n_per=200, d=3, spread=1.5)
    got, ref = both_fit(apps, X, (250, 3), n_clusters=5, seed=2,
                        max_iter=max_iter, tol=tol)
    assert_same_model(got, ref)


def test_kmeans_deterministic_and_ragged(apps):
    rs = np.random.RandomState(1)
    X, y, _ = _blobs(rs, k=3, n_per=335, d=4)  # 1005 rows: ragged blocks
    got, ref = both_fit(apps, X, (126, 4), n_clusters=3, seed=7)
    assert_same_model(got, ref)
    again = tcluster.KMeans(n_clusters=3, seed=7).fit(
        apps[1].array(X, block_shape=(126, 4)))
    assert np.array_equal(again.labels_.get(), got.labels_.get())
    assert np.array_equal(again.cluster_centers_.get(),
                          got.cluster_centers_.get())
    assert _cluster_accuracy(got.labels_.get(), y, 3) > 0.97


def test_kmeans_out_of_core(apps, tmp_path):
    """Streamed Lloyd's on a DiskArray: the reference's centers, inertia
    and iterations, and predict_ooc writes the in-core predict's labels."""
    rs = np.random.RandomState(0)
    blobs = [rs.randn(70, 4) * 0.2 + c for c in
             (np.zeros(4), np.full(4, 5.0), np.array([5, 0, 5, 0.0]))]
    real_X = np.concatenate(blobs, axis=0)
    rs.shuffle(real_X)
    models = []
    for km, app, tag in ((tcluster.KMeans, apps[1], "t"),
                         (jcluster.KMeans, apps[0], "j")):
        X = app.array(real_X, block_shape=(42, 4))
        dX = app.spill(X, str(tmp_path / f"kmX{tag}"))
        m = km(n_clusters=3, max_iter=50, seed=1).fit(dX)
        labels = m.predict_ooc(dX, out=str(tmp_path / f"kmL{tag}"))
        assert labels.shape == (210,)
        assert np.array_equal(labels.to_block_array().get(),
                              m.predict(X).get())
        with pytest.raises(AssertionError):
            m.labels_
        models.append((m, labels.to_block_array().get()))
    (got, got_lab), (ref, ref_lab) = models
    assert_same_model(got, ref, labels=False)
    assert np.array_equal(got_lab, ref_lab)
    centers = got.cluster_centers_.get()
    for c in (np.zeros(4), np.full(4, 5.0), np.array([5, 0, 5, 0.0])):
        assert np.min(np.linalg.norm(centers - c, axis=1)) < 0.5
    assert got.inertia_ < 100.0


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_kmeans_save_load_across_packages(apps, tmp_path, direction):
    rs = np.random.RandomState(2)
    real_X = _blobs(rs, 3, 40, 4)[0]
    (km_a, app_a), (km_b, app_b) = (
        ((tcluster.KMeans, apps[1]), (jcluster.KMeans, apps[0]))
        if direction == "port_to_ref" else
        ((jcluster.KMeans, apps[0]), (tcluster.KMeans, apps[1])))
    m = km_a(n_clusters=3, seed=5).fit(app_a.array(real_X, (30, 4)))
    m.save(str(tmp_path / "km"))
    m2 = km_b.load(str(tmp_path / "km"))
    assert np.array_equal(m2.cluster_centers_.get(),
                          m.cluster_centers_.get())
    assert m2.inertia_ == m.inertia_ and m2.n_iter_ == m.n_iter_
    assert np.array_equal(m2.predict(app_b.array(real_X, (30, 4))).get(),
                          m.predict(app_a.array(real_X, (30, 4))).get())
    m3 = km_a.load(str(tmp_path / "km"))  # and back in its own package
    assert np.array_equal(m3.cluster_centers_.get(),
                          m.cluster_centers_.get())


def test_kmeans_does_not_pin_training_array(apps):
    rs = np.random.RandomState(0)
    real_X = np.concatenate(
        [rs.randn(40, 3) + 5.0, rs.randn(40, 3) - 5.0], axis=0)
    got, ref = both_fit(apps, real_X, (20, 3), n_clusters=2, max_iter=20,
                        seed=1)
    assert_same_model(got, ref)
    assert not hasattr(got, "_fit_X")
    lab = got.labels_.get()
    assert lab.shape == (80,) and set(np.unique(lab)) == {0, 1}
    assert len(set(lab[:40])) == 1 and lab[0] != lab[-1]
