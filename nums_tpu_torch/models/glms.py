"""Generalized linear models, Newton path.

Counterpart of the subset of ``nums_tpu/models/glms.py`` on the main
path: the ``GLM`` base (in-core ``fit`` through the fused Newton solver,
``forward``, ``score``) and ``LogisticRegression`` (``fit``, ``predict``,
``predict_proba``). The eager solvers, the other families, out-of-core
training and save/load are later steps of the port.

``from_reference_params`` builds a fitted model from the state that
``nums_tpu``'s ``GLM.save`` writes (its ``model.json`` fields plus
``beta``, ``beta0`` and ``lambda_vec`` as numpy arrays).
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.ops import cuda_gram


class GLM:
    def __init__(
        self,
        penalty="none",
        C=1.0,
        tol=0.0001,
        max_iter=100,
        solver="newton-cg",
        fit_intercept=True,
        normalize=False,
    ):
        if fit_intercept is False:
            raise NotImplementedError(
                "fit_intercept=False currently not supported."
            )
        if normalize is True:
            raise NotImplementedError("normalize=True currently not supported.")
        if solver not in ("newton", "newton-cg"):
            raise NotImplementedError(
                f"solver {solver!r}: only the Newton solver is ported"
            )
        self._app = _instance()
        self._penalty = None if penalty == "none" else penalty
        if self._penalty not in (None, "l2"):
            raise NotImplementedError(
                f"{self._penalty} penalty: only none and l2 are ported"
            )
        self._lambda = 1.0 / C
        self._lambda_vec = None
        self._tol = tol
        self._max_iter = max_iter
        self._beta = None
        self._beta0 = None

    _fused_kind = None  # set by subclasses that support the fused solver

    def fit(self, X: BlockArray, y: BlockArray):
        """X is augmented with a ones column, so the last component of
        beta is the intercept (glms.py:72-169 of the reference)."""
        assert X.ndim == 2 and y.ndim == 1
        app = self._app
        X = app.concatenate(
            [X, app.ones((X.shape[0], 1), (X.block_shape[0], 1),
                         dtype=X.dtype)],
            axis=1,
            axis_block_size=X.block_shape[1],
        )
        beta = app.zeros((X.shape[1],), (X.block_shape[1],), dtype=X.dtype)
        if self._penalty == "l2":
            # As in the reference, λ penalizes every coordinate, the
            # intercept included.
            vec = np.full(beta.shape[0], self._lambda, dtype=X.dtype)
            self._lambda_vec = app.array(vec, block_shape=beta.block_shape)
        beta = self._fused_newton(X, y, beta, self._max_iter)
        self._beta0 = beta[-1]
        self._beta = beta[:-1]
        return self

    def _fused_newton(self, X, y, beta, max_iter):
        """Newton as one on-device loop. The kernels take the fp32 design
        matrix by dtype and the precision setting alone (the reference also
        needs a lane-padded buffer, glms.py:272-287)."""
        from nums_tpu_torch.models import fast_glm

        if self._fused_kind is None:
            raise NotImplementedError("only fused GLM kinds are ported")
        Xd = X.data
        kernels = cuda_gram.enabled() and cuda_gram.supported(
            tuple(Xd.shape), Xd.dtype
        )
        lv = self._lambda_vec.data if self._lambda_vec is not None else None
        beta_data, _, _ = fast_glm.newton_fit(
            Xd, y.data, beta.data, self._tol,
            kind=self._fused_kind, max_iter=int(max_iter),
            penalized=lv is not None, lambda_vec=lv, kernels=kernels,
        )
        return BlockArray.from_torch(
            beta_data, block_shape=beta.block_shape, backend=beta.backend
        )

    def _fused_enabled(self):
        return self._fused_kind is not None and self._beta is not None

    def _check_fitted(self):
        # The fused route is the only prediction route ported.
        if not self._fused_enabled():
            raise ValueError("fit must be called first")

    def _fused_forward(self, X):
        from nums_tpu_torch.models import fast_glm

        data = fast_glm.glm_forward(
            X.data, self._beta.data, self._beta0.data, kind=self._fused_kind
        )
        return BlockArray.from_torch(
            data, block_shape=(X.block_shape[0],), backend=X.backend
        )

    def forward(self, X):
        self._check_fitted()
        return self._fused_forward(X)

    @property
    def coef_(self):
        return self._beta

    @property
    def intercept_(self):
        return self._beta0

    def score(self, X, y):
        """Classification accuracy for classifiers."""
        if isinstance(self, LogisticRegression):
            return (self.predict(X) == y.astype(np.int64)).mean()
        raise NotImplementedError("R² scores are a later port")

    def predict(self, X):
        raise NotImplementedError()

    @classmethod
    def from_reference_params(cls, meta: dict, arrays: dict):
        """A fitted model from ``nums_tpu`` model state: ``meta`` holds the
        ``model.json`` fields of ``GLM.save`` (glms.py:475-486), ``arrays``
        holds ``beta`` and optionally ``lambda_vec`` as numpy arrays
        (``beta0`` may come from either)."""
        model_cls = _MODEL_REGISTRY.get(meta.get("model", cls.__name__))
        if model_cls is None:
            raise NotImplementedError(f"model {meta.get('model')!r}")
        model = model_cls(
            penalty=meta.get("penalty", "none"), C=meta.get("C", 1.0),
            tol=meta.get("tol", 0.0001), max_iter=meta.get("max_iter", 100),
            solver=meta.get("solver", "newton"),
        )
        app = model._app
        beta = np.asarray(arrays["beta"])
        model._beta = app.array(beta, block_shape=beta.shape)
        beta0 = arrays["beta0"] if "beta0" in arrays else meta["beta0"]
        model._beta0 = app.scalar(np.asarray(beta0, dtype=beta.dtype)[()])
        if arrays.get("lambda_vec") is not None:
            lv = np.asarray(arrays["lambda_vec"])
            model._lambda_vec = app.array(lv, block_shape=lv.shape)
        return model


class LogisticRegression(GLM):
    # Canonical link: logit.

    _fused_kind = "logistic"

    def predict(self, X):
        from nums_tpu_torch.models import fast_glm

        self._check_fitted()
        data = fast_glm.logistic_predict_label(
            X.data, self._beta.data, self._beta0.data
        )
        return BlockArray.from_torch(
            data, block_shape=(X.block_shape[0],), backend=X.backend
        ).astype(np.int64)

    def predict_proba(self, X):
        """(n, 2) probabilities in sklearn column order: column 1 is
        P(y = 1)."""
        y_pos = self.forward(X).reshape(
            (X.shape[0], 1), block_shape=(X.block_shape[0], 1)
        )
        y_neg = 1 - y_pos
        return self._app.concatenate([y_neg, y_pos], axis=1,
                                     axis_block_size=2)


_MODEL_REGISTRY = {
    "LogisticRegression": LogisticRegression,
}
