"""Bayesian optimization with expected improvement.

Port of the JAX package's ``autotune/bayesian_optimization.py``,
unchanged, with the same seeded candidate sampler. Reference:
horovod/common/optim/bayesian_optimization.cc/.h (308 LoC) — EI
acquisition over sampled test points, driven by the GP regressor.
"""

import numpy as np
from scipy.stats import norm

from horovod_tpu_torch.autotune.gaussian_process import (
    GaussianProcessRegressor)


class BayesianOptimization:
    def __init__(self, bounds, alpha=1e-8, xi=0.01, seed=0):
        """``bounds``: array (d, 2) of [low, high] per dimension
        (reference: BayesianOptimization ctor with test points)."""
        self.bounds = np.asarray(bounds, float)
        self.xi = xi
        self.gp = GaussianProcessRegressor(alpha=alpha)
        self.x_samples = []
        self.y_samples = []
        self._rng = np.random.default_rng(seed)

    def add_sample(self, x, y):
        """reference: AddSample — record an observed objective value."""
        self.x_samples.append(np.atleast_1d(np.asarray(x, float)))
        self.y_samples.append(float(y))

    def expected_improvement(self, x):
        """reference: ExpectedImprovement."""
        mu, sigma = self.gp.predict(x)
        best = np.max(self.y_samples)
        imp = mu - best - self.xi
        z = np.where(sigma > 0, imp / sigma, 0.0)
        ei = imp * norm.cdf(z) + sigma * norm.pdf(z)
        return np.where(sigma > 0, ei, 0.0)

    def next_sample(self, n_candidates=256):
        """Fit the GP and return the EI-argmax candidate
        (reference: NextSample with random restarts)."""
        d = len(self.bounds)
        if not self.x_samples:
            return self.bounds[:, 0] + self._rng.random(d) * (
                self.bounds[:, 1] - self.bounds[:, 0])
        self.gp.fit(np.stack(self.x_samples), np.asarray(self.y_samples))
        cands = self.bounds[:, 0] + self._rng.random((n_candidates, d)) * (
            self.bounds[:, 1] - self.bounds[:, 0])
        ei = self.expected_improvement(cands)
        return cands[int(np.argmax(ei))]
