"""Generalized linear models with the reference's solvers.

Counterpart of ``nums_tpu/models/glms.py`` in core memory: the four
families (linear, logistic, Poisson, exponential), the sklearn aliases
(``PoissonRegressor``, ``Ridge``, ``Lasso``, ``ElasticNet``), the eager
per-op solvers (gd, sgd, block_sgd, newton, irls) over ``BlockArray``s,
and the fused solvers of ``fast_glm`` (Newton, BFGS for ``solver=
"lbfgs"``, ADMM). The fused Newton of the logistic, linear and Poisson
families rides the Hopper kernels on float32 data in the bf16-MAC
precision class (``cuda_newton``, ``cuda_gram``); the eager linear Newton
reaches the gram kernel through ``X.T @ X`` (``BlockArray._gram_fast``).

Out-of-core training and ``save``/``load`` need the filesystem and the
disk arrays, a later port. ``from_reference_params`` builds a fitted model
from the state that ``nums_tpu``'s ``GLM.save`` writes (its
``model.json`` fields plus ``beta``, ``beta0`` and ``lambda_vec`` as numpy
arrays).
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array.random import NumsRandomState
from nums_tpu_torch.core.ops import cuda_gram


class GLM:
    def __init__(
        self,
        penalty="none",
        C=1.0,
        tol=0.0001,
        max_iter=100,
        solver="newton-cg",
        lr=0.01,
        admm_rho=1.0,
        l1_ratio=0.5,
        random_state=None,
        fit_intercept=True,
        normalize=False,
    ):
        if fit_intercept is False:
            raise NotImplementedError(
                "fit_intercept=False currently not supported."
            )
        if normalize is True:
            raise NotImplementedError("normalize=True currently not supported.")

        self._app = _instance()
        if random_state is None:
            self.rs = self._app.random
        elif isinstance(random_state, (int, np.integer)):
            self.rs = NumsRandomState(self._app.backend, seed=random_state)
        elif isinstance(random_state, NumsRandomState):
            self.rs = random_state
        else:
            raise Exception(
                f"Unexpected type for random_state {type(random_state)}"
            )
        self._penalty = None if penalty == "none" else penalty
        if self._penalty not in (None, "l2", "l1", "elasticnet"):
            raise NotImplementedError(f"{self._penalty} penalty not supported")
        if self._penalty in ("l1", "elasticnet") and solver != "admm":
            # l1/elasticnet are non-smooth: only the proximal (ADMM)
            # solver handles them.
            raise NotImplementedError(
                f"{self._penalty} penalty requires solver='admm'."
            )
        self._l1_ratio = float(l1_ratio)
        self._lambda = 1.0 / C
        self._lambda_vec = None
        self._tol = tol
        self._max_iter = max_iter
        self._opt = solver
        self._lr = lr
        self._admm_rho = float(admm_rho)
        self._beta = None
        self._beta0 = None

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
        tol = app.scalar(self._tol)
        max_iter = self._max_iter
        vec = self._lambda_host_vec(X.shape[0], beta.shape[0], dtype=X.dtype)
        if vec is not None:
            self._lambda_vec = app.array(vec, block_shape=beta.block_shape)
        if self._opt in ("gd", "sgd", "block_sgd"):
            lr = app.scalar(self._lr)
            opt = {"gd": gd, "sgd": sgd, "block_sgd": block_sgd}[self._opt]
            beta = opt(self, beta, X, y, tol, max_iter, lr)
        elif self._opt in ("newton", "newton-cg"):
            fused = self._fused_newton(X, y, beta, max_iter)
            if fused is not None:
                beta = fused
            else:
                beta = newton(app, self, beta, X, y, tol, max_iter)
        elif self._opt == "irls":
            assert isinstance(self, LogisticRegression)
            beta = irls(app, self, beta, X, y, tol, max_iter)
        elif self._opt == "lbfgs":
            if self._fused_kind is None:
                raise NotImplementedError(
                    "lbfgs unsupported for this model family."
                )
            from nums_tpu_torch.models import fast_glm

            lv = self._lambda_vec.data if self._lambda_vec is not None else None
            beta_data = fast_glm.bfgs_fit(
                X.data, y.data, beta.data, self._tol,
                kind=self._fused_kind, max_iter=int(max_iter),
                penalized=lv is not None, lambda_vec=lv,
            )
            beta = BlockArray.from_torch(
                beta_data, block_shape=beta.block_shape, backend=beta.backend
            )
        elif self._opt == "admm":
            if self._fused_kind is None:
                raise NotImplementedError(
                    "admm unsupported for this model family."
                )
            from nums_tpu_torch.models import fast_glm

            lv = self._lambda_vec.data if self._lambda_vec is not None else None
            beta_data, _, _ = fast_glm.admm_fit(
                X.data, y.data, beta.data, self._tol,
                kind=self._fused_kind, max_iter=int(max_iter),
                rho=self._admm_rho,
                penalty=self._penalty, lambda_vec=lv,
                l1_ratio=self._l1_ratio,
            )
            beta = BlockArray.from_torch(
                beta_data, block_shape=beta.block_shape, backend=beta.backend
            )
        else:
            raise Exception(f"Unsupported optimizer specified {self._opt}.")
        self._beta0 = beta[-1]
        self._beta = beta[:-1]
        return self

    _fused_kind = None  # set by subclasses that support the fused solver
    # As in the reference, lambda_vec penalizes every coordinate including
    # the intercept; the sklearn aliases override.
    _penalize_intercept = True
    _sklearn_alpha_scale = False

    def _fused_newton(self, X, y, beta, max_iter):
        """Newton as one on-device loop (``fast_glm.newton_fit``), or None
        for the eager solver: when ``settings.glm_fuse`` is off or the
        family has no fused kind (glms.py:256-308 of the reference). The
        kernels take the fp32 design matrix by dtype and the precision
        setting alone (the reference also needs a lane-padded buffer); a
        failed kernel raises and is never replaced by the eager route."""
        from nums_tpu_torch.core import settings
        from nums_tpu_torch.models import fast_glm

        if settings.glm_fuse in ("0", "false") or self._fused_kind is None:
            return None
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
        from nums_tpu_torch.core import settings

        return (
            settings.glm_fuse not in ("0", "false")
            and self._fused_kind is not None
            and self._beta is not None
        )

    def _check_fitted(self):
        if self._beta is None:
            raise ValueError("fit must be called first")

    def _fused_forward(self, X):
        from nums_tpu_torch.models import fast_glm

        data = fast_glm.glm_forward(
            X.data, self._beta.data, self._beta0.data, kind=self._fused_kind
        )
        return BlockArray.from_torch(
            data, block_shape=(X.block_shape[0],), backend=X.backend
        )

    def forward(self, X, beta=None):
        """link⁻¹(X·beta) for the solvers' augmented beta, or the fitted
        model's mean response when ``beta`` is None."""
        if beta is not None:
            return self.link_inv(X @ beta)
        self._check_fitted()
        if self._fused_enabled():
            return self._fused_forward(X)
        return self.link_inv(self._beta0 + X @ self._beta)

    def grad_norm_sq(self, X, y, beta=None):
        g = self.gradient(X, y, self.forward(X, beta), beta=beta)
        return g.T @ g

    def _lambda_host_vec(self, n_rows, width, dtype=np.float64):
        """Per-coordinate penalty vector, None when unpenalized."""
        if self._penalty not in ("l2", "l1", "elasticnet"):
            return None
        lam = self._lambda
        if self._sklearn_alpha_scale:
            # sklearn's Lasso/ElasticNet objective carries a 1/(2n)
            # factor on the residual term; ours doesn't, so the
            # equivalent per-coordinate λ is n·alpha.
            lam = lam * n_rows
        vec = np.full(width, lam, dtype=dtype)
        if not self._penalize_intercept:
            # sklearn never penalizes the intercept (the appended ones
            # column, the last beta coordinate).
            vec[-1] = 0.0
        return vec

    def _lam_for(self, X):
        """λ vector sized for X's columns: during fit X is intercept-
        augmented (width d+1 == len(lambda_vec)); after fit callers pass
        the raw d-column X, so the intercept slot is dropped."""
        lv = self._lambda_vec
        if lv is not None and lv.shape[0] == X.shape[1] + 1:
            return lv[:-1]
        return lv

    def _beta_for_penalty(self, X, beta):
        """The coefficient vector the l2 term applies to: the solver's
        augmented beta during fit, the fitted coefficients after."""
        if beta is not None:
            return beta
        assert self._beta is not None, "penalized gradient needs beta"
        return self._beta

    def predict(self, X):
        raise NotImplementedError()

    def link_inv(self, eta):
        raise NotImplementedError()

    def objective(self, X, y, beta=None):
        raise NotImplementedError()

    def gradient(self, X, y, mu=None, beta=None):
        raise NotImplementedError()

    def hessian(self, X, y, mu=None):
        raise NotImplementedError()

    def deviance(self, y, y_pred):
        raise NotImplementedError()

    def deviance_sqr(self, X, y):
        app = self._app
        y_pred = self.predict(X)
        dev = self.deviance(y, y_pred)
        y_mean = app.mean(y)
        dev_null = self.deviance(y, y_mean)
        # Constant-y guard (the convention of metrics.r2_score):
        # dev_null == 0 would otherwise give -inf or nan.
        one, zero = app.scalar(1.0), app.scalar(0.0)
        null_zero = dev_null == zero
        score = one - dev / app.where(null_zero, one, dev_null)
        return app.where(
            null_zero, app.where(dev == zero, one, zero), score
        )

    @property
    def coef_(self):
        return self._beta

    @property
    def intercept_(self):
        return self._beta0

    def score(self, X, y):
        """Classification accuracy for classifiers; R² otherwise."""
        if isinstance(self, LogisticRegression):
            return (self.predict(X) == y.astype(np.int64)).mean()
        return self.deviance_sqr(X, y)

    def save(self, filename: str):
        raise NotImplementedError(
            "GLM.save needs the filesystem port; use nums_tpu's GLM.save and "
            "GLM.from_reference_params"
        )

    @classmethod
    def load(cls, filename: str):
        raise NotImplementedError(
            "GLM.load needs the filesystem port; use "
            "GLM.from_reference_params"
        )

    @classmethod
    def from_reference_params(cls, meta: dict, arrays: dict):
        """A fitted model from ``nums_tpu`` model state: ``meta`` holds the
        ``model.json`` fields of ``GLM.save`` (glms.py:475-486), ``arrays``
        holds ``beta`` and optionally ``lambda_vec`` as numpy arrays
        (``beta0`` may come from either). The hyperparameters are restored
        as the reference's ``GLM.load`` restores them (glms.py:501-520)."""
        model_cls = _MODEL_REGISTRY.get(meta.get("model", cls.__name__))
        if model_cls is None:
            raise NotImplementedError(f"model {meta.get('model')!r}")
        common = dict(
            tol=meta.get("tol", 0.0001), max_iter=meta.get("max_iter", 100),
            lr=meta.get("lr", 0.01), admm_rho=meta.get("admm_rho", 1.0),
            l1_ratio=meta.get("l1_ratio", 0.5),
        )
        C = meta.get("C", 1.0)
        if issubclass(model_cls, (Lasso, ElasticNet)):
            # The alias constructors fix penalty and solver (always admm)
            # and take sklearn's alpha (== 1/C).
            model = model_cls(alpha=1.0 / C, **common)
        elif issubclass(model_cls, Ridge):
            # Ridge's solver is the user's choice: restore the saved one.
            model = model_cls(alpha=1.0 / C,
                              solver=meta.get("solver", "newton"), **common)
        else:
            model = model_cls(
                penalty=meta.get("penalty", "none"), C=C,
                solver=meta.get("solver", "newton"), **common,
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


class LinearRegression(GLM):
    # Canonical link: identity.

    _fused_kind = "linear"

    def link_inv(self, eta):
        return eta

    def objective(self, X, y, beta=None):
        assert beta is not None or self._beta is not None
        mu = self.forward(X, beta)
        # Unpenalized, as the reference's objectives: the penalty enters
        # through gradient/hessian in the Newton solvers.
        return self._app.sum((y - mu) ** self._app.two)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        if self._penalty != "l2":
            return X.T @ (mu - y)
        b = self._beta_for_penalty(X, beta)
        return X.T @ (mu - y) + self._lam_for(X) * b

    def hessian(self, X, y, mu=None):
        if self._penalty != "l2":
            return X.T @ X
        return X.T @ X + self._app.diag(self._lam_for(X))

    def deviance(self, y, y_pred):
        return self._app.sum((y - y_pred) ** self._app.two)

    def predict(self, X):
        return self.forward(X)


class LogisticRegression(GLM):
    # Canonical link: logit.

    _fused_kind = "logistic"

    def link_inv(self, eta):
        app = self._app
        return app.one / (app.one + app.exp(-eta))

    def objective(self, X, y, beta=None):
        assert beta is not None or self._beta is not None
        app = self._app
        mu = self.forward(X, beta)
        return -app.sum(y * app.log(mu) + (app.one - y) * app.log(app.one - mu))

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        if self._penalty != "l2":
            return X.T @ (mu - y)
        b = self._beta_for_penalty(X, beta)
        return X.T @ (mu - y) + self._lam_for(X) * b

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        dim, block_dim = mu.shape[0], mu.block_shape[0]
        s = (mu * (self._app.one - mu)).reshape(
            (dim, 1), block_shape=(block_dim, 1)
        )
        if self._penalty != "l2":
            return X.T @ (s * X)
        # diag(λ): upstream NumS adds λ_j to every entry of column j, an
        # asymmetric perturbation that nums_tpu repairs (DIVERGENCES.md);
        # the fused path adds the same diagonal.
        return X.T @ (s * X) + self._app.diag(self._lam_for(X))

    def deviance(self, y, y_pred):
        raise NotImplementedError()

    def predict(self, X):
        from nums_tpu_torch.models import fast_glm

        self._check_fitted()
        if self._fused_enabled():
            data = fast_glm.logistic_predict_label(
                X.data, self._beta.data, self._beta0.data
            )
            return BlockArray.from_torch(
                data, block_shape=(X.block_shape[0],), backend=X.backend
            ).astype(np.int64)
        return (self.forward(X) > 0.5).astype(np.int64)

    def predict_proba(self, X):
        """(n, 2) probabilities in sklearn column order: column 1 is
        P(y = 1)."""
        y_pos = self.forward(X).reshape(
            (X.shape[0], 1), block_shape=(X.block_shape[0], 1)
        )
        y_neg = 1 - y_pos
        return self._app.concatenate([y_neg, y_pos], axis=1,
                                     axis_block_size=2)


class PoissonRegression(GLM):
    # Canonical link: log.

    _fused_kind = "poisson"

    def link_inv(self, eta):
        return self._app.exp(eta)

    def objective(self, X, y, beta=None):
        if beta is None:
            eta = X @ self._beta + self._beta0
        else:
            eta = X @ beta
        mu = self._app.exp(eta)
        return self._app.sum(mu - y * eta)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        return X.T @ (mu - y)

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        return (X.T * mu) @ X

    def deviance(self, y, y_pred):
        app = self._app
        return app.sum(app.two * app.xlogy(y, y / y_pred) - y + y_pred)

    def predict(self, X):
        return self.forward(X)


class ExponentialRegression(GLM):
    """Exponential GLM with log link, y ~ Exp(rate = 1/mu), mu = exp(eta):

      NLL      = sum(log mu + y/mu)
      gradient = Xᵀ(1 - y/mu)
      hessian  = Xᵀ diag(y/mu) X  (observed information)
    """

    _fused_kind = None  # eager Newton only (observed-information step)

    def link_inv(self, eta):
        return self._app.exp(eta)

    def objective(self, X, y, beta=None):
        app = self._app
        mu = self.forward(X, beta)
        return app.sum(app.log(mu) + y / mu)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        return X.T @ (self._app.one - y / mu)

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        w = y / mu
        dim, block_dim = w.shape[0], w.block_shape[0]
        w2 = w.reshape((dim, 1), block_shape=(block_dim, 1))
        return X.T @ (w2 * X)

    def deviance(self, y, y_pred):
        app = self._app
        r = y / y_pred
        return app.sum(app.two * (r - app.log(r) - app.one))

    def predict(self, X):
        return self.forward(X)


# Scikit-Learn alias.
PoissonRegressor = PoissonRegression


def sgd(model, beta, X, y, tol, max_iter, lr):
    """Single-sample SGD."""
    app = _instance()
    # One generator for the whole run: rs.numpy() reseeds on every call,
    # so drawing inside the loop would train on one fixed row.
    rng = model.rs.numpy()
    for _ in range(max_iter):
        idx = int(rng.integers(X.shape[0]))
        X_sample, y_sample = X[idx : idx + 1], y[idx : idx + 1]
        mu = model.forward(X_sample, beta)
        g = model.gradient(X_sample, y_sample, mu, beta=beta)
        beta += -lr * g
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def block_sgd(model, beta, X, y, tol, max_iter, lr):
    """Per-block minibatch SGD."""
    app = _instance()
    for _ in range(max_iter):
        for start, stop in X.grid.grid_slices[0]:
            X_batch, y_batch = X[start:stop], y[start:stop]
            mu = model.forward(X_batch, beta)
            g = model.gradient(X_batch, y_batch, mu, beta=beta)
            beta += -lr * g
            if app.max(app.abs(g)) <= tol:
                break
    return beta


def gd(model, beta, X, y, tol, max_iter, lr):
    app = _instance()
    for _ in range(max_iter):
        mu = model.forward(X, beta)
        g = model.gradient(X, y, mu, beta=beta)
        beta += -lr * g
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def newton(app, model, beta, X, y, tol, max_iter):
    """Eager Newton: a Cholesky solve of the Hessian per iteration, and
    one host sync per iteration for the convergence test."""
    for _ in range(max_iter):
        mu = model.forward(X, beta)
        g = model.gradient(X, y, mu, beta=beta)
        beta += -app.posdef_solve(model.hessian(X, y, mu), g)
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def irls(app, model, beta, X, y, tol, max_iter):
    for _ in range(max_iter):
        eta = X @ beta
        mu = model.link_inv(eta)
        s = mu * (1 - mu) + 1e-16
        XT_s = X.T * s
        z = eta + (y - mu) / s
        beta = app.posdef_solve(XT_s @ X, XT_s @ z)
        # Freed here, not when the next iteration rebinds it: XT_s is as
        # large as X, and two of them would be alive at once.
        del XT_s
        g = model.gradient(X, y, mu, beta)
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def lbfgs(*args, **kwargs):
    """No eager per-op L-BFGS: the solver is ``fast_glm.bfgs_fit``, through
    ``solver='lbfgs'`` on any GLM with a fused kind."""
    raise NotImplementedError("use GLM(solver='lbfgs') — fused L-BFGS")


def admm(*args, **kwargs):
    """No eager per-op ADMM: the solver is ``fast_glm.admm_fit``, through
    ``solver='admm'`` on any GLM with a fused kind."""
    raise NotImplementedError("use GLM(solver='admm') — fused ADMM")


# -- sklearn-style penalized regressions (sklearn's alpha == λ == 1/C) ----


class Ridge(LinearRegression):
    """l2-penalized linear regression, sklearn semantics:
    min ‖y − Xβ‖² + alpha·‖β‖² with an unpenalized intercept (no 1/n
    factor, so λ == alpha)."""

    _penalize_intercept = False

    def __init__(self, alpha=1.0, **kwargs):
        kwargs.setdefault("solver", "newton")
        super().__init__(penalty="l2", C=1.0 / float(alpha), **kwargs)


class Lasso(LinearRegression):
    """l1-penalized linear regression by ADMM, sklearn semantics:
    min 1/(2n)‖y − Xβ‖² + alpha·‖β‖₁, intercept unpenalized (λ = n·alpha
    against the unnormalized residual objective)."""

    _penalize_intercept = False
    _sklearn_alpha_scale = True

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(
            penalty="l1", C=1.0 / float(alpha), solver="admm", **kwargs
        )


class ElasticNet(LinearRegression):
    """l1+l2-penalized linear regression by ADMM, sklearn semantics:
    min 1/(2n)‖y − Xβ‖² + alpha·l1_ratio·‖β‖₁
    + alpha·(1−l1_ratio)/2·‖β‖², intercept unpenalized."""

    _penalize_intercept = False
    _sklearn_alpha_scale = True

    def __init__(self, alpha=1.0, l1_ratio=0.5, **kwargs):
        super().__init__(
            penalty="elasticnet", C=1.0 / float(alpha), solver="admm",
            l1_ratio=l1_ratio, **kwargs
        )


_MODEL_REGISTRY = {
    "LinearRegression": LinearRegression,
    "LogisticRegression": LogisticRegression,
    "PoissonRegression": PoissonRegression,
    "ExponentialRegression": ExponentialRegression,
    "Ridge": Ridge,
    "Lasso": Lasso,
    "ElasticNet": ElasticNet,
}
