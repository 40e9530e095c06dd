"""``nums_tpu_torch.numpy.linalg`` against ``nums_tpu.numpy.linalg``, and
the gram kernel's route through the facade's contractions.

The cases of tests/numpy/test_linalg_facade.py, with the same numpy
inputs through both packages on the CPU (x64 on, float64; and float32),
compared within 1e-10 (float64) and 1e-4 (float32) of max|ref|;
eigenvectors and singular vectors up to sign (each column's sign set by
its largest entry), the QR factors as |R| and QR. Where the reference
raises, the port raises the same exception type.

The K1 route test: every contraction form that reaches the reference's
Pallas gram (its ``_pallas_gram_fast``, with lane padding and the kernel
forced on: ``padded_jax_app``, interpret mode) reaches the port's
``cuda_gram.gram`` (its plain version on a CPU tensor), as many times;
the results agree at ``GRAM_BF16_REL``, and under
``matmul_precision="highest"`` the port takes plain float32, within the
float32 class of the reference's exact product.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, apps, assert_values, facade_parity, jax_app,
    padded_jax_app, rel_err, spy_calls, torch_app,
)

import nums_tpu.numpy as jnps
import nums_tpu_torch.numpy as tnps
from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import cuda_gram

RS = np.random.RandomState(0)
A = RS.randn(12, 5)
SPD = (lambda a: a @ a.T + 6 * np.eye(6))(RS.randn(6, 6))
B = RS.randn(6)
T6 = (RS.randn(6, 6) + 6 * np.eye(6))
ROT = np.array([[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]])


def _signed(v):
    """Columns of ``v`` with the sign of each column's largest entry
    made positive."""
    v = np.asarray(v)
    idx = np.argmax(np.abs(v), axis=0)
    return v * np.sign(v[idx, np.arange(v.shape[1])])


CASES = {
    "qr": lambda la, n, x: (lambda q, r: (np.abs(r.get()), (q @ r).get()))(
        *la.qr(n.array(x))),
    "qr_complete": lambda la, n, x: la.qr(n.array(x), mode="complete"),
    "svd": lambda la, n, x: (lambda u, s, vt: (
        _signed(u.get()), s, _signed(vt.get().T)))(*la.svd(n.array(x))),
    "svd_values": lambda la, n, x: la.svd(n.array(x), compute_uv=False),
    "svd_full": lambda la, n, x: la.svd(n.array(x), full_matrices=True),
    "svdvals": lambda la, n, x: la.svdvals(n.array(x)),
    "inv": lambda la, n, x: la.inv(n.array(SPD)),
    "cholesky": lambda la, n, x: la.cholesky(n.array(SPD)),
    "det": lambda la, n, x: la.det(n.array(SPD)),
    "slogdet": lambda la, n, x: la.slogdet(n.array(SPD - 8 * np.eye(6))),
    "eigh": lambda la, n, x: (lambda w, v: (w, _signed(v.get())))(
        *la.eigh(n.array(SPD))),
    "eigh_unsymmetric": lambda la, n, x: la.eigh(n.array(SPD + np.triu(
        np.ones((6, 6)), 1)))[0],
    "eigvalsh": lambda la, n, x: la.eigvalsh(n.array(SPD)),
    "matrix_rank": lambda la, n, x: [la.matrix_rank(n.array(SPD)),
                                     la.matrix_rank(n.array(
                                         np.outer(B, B)))],
    "cond": lambda la, n, x: la.cond(n.array(SPD)),
    "cond_p": lambda la, n, x: la.cond(n.array(SPD), p=1),
    "matrix_power": lambda la, n, x: [la.matrix_power(n.array(SPD), 3),
                                      la.matrix_power(n.array(SPD), 0)],
    "solve": lambda la, n, x: [la.solve(n.array(SPD), n.array(B)),
                               la.solve(n.array(SPD), n.array(SPD[:, :2]))],
    "lstsq": lambda la, n, x: la.lstsq(n.array(x), n.array(x[:, 0] + 1)),
    "pinv": lambda la, n, x: la.pinv(n.array(x)),
    "multi_dot": lambda la, n, x: la.multi_dot(
        [n.array(x), n.array(x.T), n.array(x[:, 0])]),
    "matmul": lambda la, n, x: la.matmul(n.array(SPD), n.array(B)),
    "tensordot": lambda la, n, x: la.tensordot(n.array(x), n.array(x.T),
                                               axes=1),
    "norm": lambda la, n, x: [la.norm(n.array(B)),
                              la.vector_norm(n.array(B))],
    "matrix_norm": lambda la, n, x: la.matrix_norm(n.array(x)),
    "matrix_norm_nuc": lambda la, n, x: la.matrix_norm(n.array(x),
                                                       ord="nuc"),
    "matrix_transpose": lambda la, n, x: la.matrix_transpose(n.array(x)),
    "diagonal": lambda la, n, x: la.diagonal(n.array(SPD)),
    "cross": lambda la, n, x: la.cross(n.array(x[:4, :3]),
                                       n.array(x[4:8, :3])),
    "vecdot": lambda la, n, x: la.vecdot(n.array(x), n.array(x)),
    "outer": lambda la, n, x: la.outer(n.array(x[0]), n.array(x[1])),
    "trace": lambda la, n, x: la.trace(n.array(SPD)),
    "tensorsolve": lambda la, n, x: la.tensorsolve(
        n.array(T6.reshape(2, 3, 6)),
        n.array(np.arange(6.0).reshape(2, 3))),
    "tensorinv": lambda la, n, x: la.tensorinv(n.array(
        T6.reshape(3, 2, 6)), ind=2),
    "eig_real": lambda la, n, x: (lambda w, v: (np.sort(w.get()),
                                                w.get().dtype,
                                                v.get().dtype))(
        *la.eig(n.array(SPD))),
    "eig_complex": lambda la, n, x: la.eig(n.array(ROT)),
    "eigvals": lambda la, n, x: [np.sort_complex(la.eigvals(
        n.array(ROT)).get()), np.sort(la.eigvals(n.array(SPD)).get())],
}


# Built in float64 (eig runs LAPACK on the host in the input's dtype).
FLOAT64_ONLY = ("eig_real", "eig_complex", "eigvals", "tensorsolve",
                "tensorinv")
LINALG_PARAMS = [(case, dtype) for case in sorted(CASES)
                 for dtype in ("float64", "float32")
                 if dtype == "float64" or case not in FLOAT64_ONLY]


@pytest.mark.parametrize("case,dtype", LINALG_PARAMS)
def test_linalg(apps, case, dtype):
    x = A.astype(dtype)
    facade_parity(apps, lambda nps, app: CASES[case](nps.linalg, nps, x),
                  "linalg")


def test_every_name_has_a_case():
    """Each public function of the reference's ``numpy.linalg`` is the
    name or the prefix of a case (``vector_norm`` rides ``norm``)."""
    from nums_tpu.numpy import linalg as jla

    names = {n for n in vars(jla) if not n.startswith("_")
             and callable(vars(jla)[n])}
    covered = {n for n in names for c in CASES
               if c == n or c.startswith(n + "_")} | {"vector_norm"}
    assert names == covered, sorted(names - covered)


# The contraction forms of the facade that reach the gram kernel.
FORMS = {
    "matmul_operator": lambda n, X: X.T @ X,
    "nps_matmul": lambda n, X: n.matmul(X.T, X),
    "nps_dot": lambda n, X: n.dot(X.T, X),
    "nps_tensordot": lambda n, X: n.tensordot(X.T, X, axes=1),
    "method_dot": lambda n, X: X.T.dot(X),
    "linalg_matmul": lambda n, X: n.linalg.matmul(X.T, X),
    "multi_dot": lambda n, X: n.linalg.multi_dot([X.T, X]),
    "nps_transpose": lambda n, X: n.matmul(n.transpose(X), X),
    # Not a gram: two arrays, or a materialized transpose.
    "two_arrays": lambda n, X: n.matmul(X.T, n.array(X.get())),
    "x_xt": lambda n, X: X @ X.T,
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_gram_kernel_route_matches_the_pallas_route(padded_jax_app,
                                                    torch_app, spy_calls,
                                                    form):
    from nums_tpu.core.ops import pallas_gram
    from nums_tpu_torch.core import application_manager as tam

    tam.set_instance(torch_app)
    # The reference's kernel streams at least 4 chunks of 128 rows.
    x = np.random.RandomState(2).randn(512, 100).astype(np.float32)
    ref_calls = spy_calls(pallas_gram, "gram_fn")
    calls = spy_calls(cuda_gram, "gram")
    ref = FORMS[form](jnps, jnps.array(x))
    got = FORMS[form](tnps, tnps.array(x))
    assert len(calls) == len(ref_calls), (len(calls), len(ref_calls))
    assert rel_err(got.get(), ref.get()) < GRAM_BF16_REL
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if form in ("matmul_operator", "nps_dot", "multi_dot"):
        assert len(calls) == 1


def test_gram_under_highest_is_plain_float32(jax_app, torch_app, spy_calls,
                                             monkeypatch):
    from nums_tpu.core import application_manager as jam
    from nums_tpu_torch.core import application_manager as tam

    jam.set_instance(jax_app)
    tam.set_instance(torch_app)
    monkeypatch.setattr(settings, "matmul_precision", "highest")
    calls = spy_calls(cuda_gram, "gram")
    x = np.random.RandomState(2).randn(300, 100).astype(np.float32)
    got = tnps.matmul(tnps.array(x).T, tnps.array(x))
    ref = jnps.matmul(jnps.array(x).T, jnps.array(x))
    assert not calls
    assert_values(got.get(), ref.get(), "reduction")
