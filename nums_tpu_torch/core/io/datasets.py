"""Synthetic test data: ``BimodalGaussian``.

Counterpart of ``nums_tpu/core/io/datasets.py``, in numpy alone, so the
same seed gives the same arrays, bit for bit, in both packages.
"""

import numpy as np


class BimodalGaussian:
    """Two-Gaussian classification/regression dataset."""

    @classmethod
    def get_dataset(cls, n, d, p=0.9, seed=1, dtype=np.float64, theta=None):
        return cls(10, 2, 30, 4, dim=d, seed=seed, dtype=dtype).sample(
            n, p=p, theta=theta
        )

    def __init__(self, mu1, sigma1, mu2, sigma2, dim=2, seed=1337,
                 dtype=np.float64):
        self.dtype = dtype
        self.rs = np.random.RandomState(seed)
        self.dim = dim
        self.mu1 = self._vec(mu1)
        self.sigma1 = self._vec(sigma1)
        self.mu2 = self._vec(mu2)
        self.sigma2 = self._vec(sigma2)

    def _vec(self, v):
        if isinstance(v, np.ndarray):
            return v.astype(self.dtype)
        out = np.empty(self.dim, dtype=self.dtype)
        out[:] = v
        return out

    def sample(self, n, p=0.9, theta=None):
        """``n`` rows, a share ``p`` of them from the first Gaussian; class
        labels, or ``X @ theta`` as a regression target."""
        n1 = int(n * p)
        n2 = n - n1
        X1 = (
            self.rs.randn(n1, self.dim).astype(self.dtype) * self.sigma1
            + self.mu1
        )
        X2 = (
            self.rs.randn(n2, self.dim).astype(self.dtype) * self.sigma2
            + self.mu2
        )
        if theta is None:
            y1 = np.ones(n1, dtype=self.dtype)
            y2 = np.zeros(n2, dtype=self.dtype)
        else:
            y1 = X1 @ theta
            y2 = X2 @ theta
        X = np.concatenate([X1, X2], axis=0).astype(self.dtype)
        y = np.concatenate([y1, y2], axis=0).astype(self.dtype)
        idx = self.rs.permutation(n)
        return X[idx], y[idx]
