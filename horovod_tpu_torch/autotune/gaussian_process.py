"""Gaussian-process regression for the autotuner.

Port of the JAX package's ``autotune/gaussian_process.py``, unchanged: it
is numpy and scipy on the host. Reference:
horovod/common/optim/gaussian_process.cc/.h (300 LoC, Eigen + LBFGS
hyperparameter fitting). Same model — RBF kernel GP with noise, fitted
by maximizing the log marginal likelihood — expressed in numpy/scipy, which is
the idiomatic host-side tool here (the autotuner runs on the Python control
plane; there is no reason for C++).
"""

import numpy as np
from scipy.linalg import cho_factor, cho_solve
from scipy.optimize import minimize


class GaussianProcessRegressor:
    """RBF-kernel GP with observation noise
    (reference: gaussian_process.h GaussianProcessRegressor)."""

    def __init__(self, alpha=1e-8):
        self.alpha = alpha
        self.length = 1.0
        self.sigma_f = 1.0
        self.x_train = None
        self.y_train = None

    def kernel(self, x1, x2, length=None, sigma_f=None):
        length = self.length if length is None else length
        sigma_f = self.sigma_f if sigma_f is None else sigma_f
        sq = np.sum(x1 ** 2, 1)[:, None] + np.sum(x2 ** 2, 1)[None] \
            - 2 * x1 @ x2.T
        return sigma_f ** 2 * np.exp(-0.5 * np.maximum(sq, 0) / length ** 2)

    def fit(self, x, y):
        self.x_train = np.atleast_2d(np.asarray(x, float))
        self.y_train = np.asarray(y, float).reshape(-1, 1)

        def nll(theta):
            length, sigma_f = np.exp(theta)
            k = self.kernel(self.x_train, self.x_train, length, sigma_f)
            k = k + self.alpha * np.eye(len(self.x_train))
            try:
                c, low = cho_factor(k + 1e-10 * np.eye(len(k)))
            except np.linalg.LinAlgError:
                return 1e25
            a = cho_solve((c, low), self.y_train)
            return (
                0.5 * float((self.y_train.T @ a)[0, 0])
                + float(np.sum(np.log(np.abs(np.diag(c)))))
                + 0.5 * len(k) * np.log(2 * np.pi))

        best = None
        # multi-start L-BFGS-B over log hyperparams
        # (reference uses third_party/lbfgs the same way)
        for x0 in ([0.0, 0.0], [1.0, 0.0], [-1.0, 1.0]):
            r = minimize(nll, x0, method="L-BFGS-B",
                         bounds=[(-5, 5), (-5, 5)])
            if best is None or r.fun < best.fun:
                best = r
        self.length, self.sigma_f = np.exp(best.x)
        return self

    def predict(self, x):
        """Posterior mean and std at test points."""
        x = np.atleast_2d(np.asarray(x, float))
        if self.x_train is None:
            return np.zeros(len(x)), np.ones(len(x))
        k = self.kernel(self.x_train, self.x_train) \
            + self.alpha * np.eye(len(self.x_train))
        ks = self.kernel(self.x_train, x)
        kss = self.kernel(x, x)
        c, low = cho_factor(k + 1e-10 * np.eye(len(k)))
        a = cho_solve((c, low), self.y_train)
        mu = (ks.T @ a).ravel()
        v = cho_solve((c, low), ks)
        var = np.maximum(np.diag(kss - ks.T @ v), 1e-12)
        return mu, np.sqrt(var)
