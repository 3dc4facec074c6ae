"""Clipped distributions with closed-form partial moments.

A copy of the JAX package's ``analysis/distributions.py`` (numpy and scipy
only; it computes on the host in both packages). It re-derives the
reference's ``utils/distributions.py`` (ClippedGauss / ClippedStudentT /
Uniform with hand-expanded integrals) in terms of the three partial moments

  I0(a,b) = ∫_a^b p(x) dx,   I1(a,b) = ∫ x p dx,   I2(a,b) = ∫ x² p dx,

from which the reference's per-interval integrands follow:

  ∫ (x-u)² p dx  = I2 - 2u·I1 + u²·I0          (integr_interv_p_sqr_r)
  ∫ x (u-x) p dx = u·I1 - I2                   (integr_interv_x_p_signed_r)

For the Gaussian/Student-t these use erf / hypergeometric antiderivatives;
clipping adds point masses at the range bounds. Note: the reference's
``UniformDistr.integr_interv_x_p_signed_r`` (distributions.py:381-384)
computes ∫ (u-x) p dx — missing the x factor the Gauss/Student-t versions
have; we implement the consistent ∫ x (u-x) p dx.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.special as sc
import scipy.stats as stats


class DistrBase:
    """A (possibly clipped) scalar distribution (distributions.py:11-46)."""

    def __init__(self, params_dict: Dict, range_min: float, range_max: float):
        assert range_max >= range_min
        self.params_dict = params_dict
        self.range_min = float(range_min)
        self.range_max = float(range_max)
        self.point_mass_range_min = 0.0
        self.point_mass_range_max = 0.0

    # --- partial moments of the *unclipped* density over [a, b] ---
    def i0(self, a, b):
        raise NotImplementedError

    def i1(self, a, b):
        raise NotImplementedError

    def i2(self, a, b):
        raise NotImplementedError

    # --- per-interval integrands used by the grid integrator ---
    def integr_interv_p_sqr_r(self, a, b, u):
        """∫_a^b (x - u)² p(x) dx (squared rounding error to grid point u)."""
        assert b >= a
        return self.i2(a, b) - 2.0 * u * self.i1(a, b) + u * u * self.i0(a, b)

    def integr_interv_x_p_signed_r(self, a, b, u):
        """∫_a^b x (u - x) p(x) dx (input times signed rounding error)."""
        assert b >= a
        return u * self.i1(a, b) - self.i2(a, b)

    def eval_non_central_second_moment(self):
        """E[x²] of the *clipped* variable (distributions.py:185-189)."""
        return (
            self.point_mass_range_min * self.range_min**2
            + self.i2(self.range_min, self.range_max)
            + self.point_mass_range_max * self.range_max**2
        )

    def pdf(self, x):
        raise NotImplementedError

    def sample(self, shape, rng=None):
        raise NotImplementedError


class ClippedGaussDistr(DistrBase):
    """N(mu, sigma) clipped to [range_min, range_max]
    (distributions.py:49-189)."""

    def __init__(self, params_dict, range_min, range_max):
        super().__init__(params_dict, range_min, range_max)
        mu, sigma = params_dict["mu"], params_dict["sigma"]
        self.point_mass_range_min = stats.norm.cdf(range_min, mu, sigma)
        self.point_mass_range_max = 1.0 - stats.norm.cdf(range_max, mu, sigma)

    def _z(self, x):
        return (x - self.params_dict["mu"]) / self.params_dict["sigma"]

    def i0(self, a, b):
        return stats.norm.cdf(self._z(b)) - stats.norm.cdf(self._z(a))

    def i1(self, a, b):
        mu, sigma = self.params_dict["mu"], self.params_dict["sigma"]
        pa, pb = stats.norm.pdf(self._z(a)), stats.norm.pdf(self._z(b))
        return mu * self.i0(a, b) - sigma * (pb - pa)

    def i2(self, a, b):
        mu, sigma = self.params_dict["mu"], self.params_dict["sigma"]
        pa, pb = stats.norm.pdf(self._z(a)), stats.norm.pdf(self._z(b))
        return (mu**2 + sigma**2) * self.i0(a, b) - sigma * (
            (b + mu) * pb - (a + mu) * pa
        )

    def pdf(self, x):
        return stats.norm.pdf(x, self.params_dict["mu"], self.params_dict["sigma"])

    def cdf(self, x):
        return stats.norm.cdf(x, self.params_dict["mu"], self.params_dict["sigma"])

    def sample(self, shape, rng=None):
        rng = rng or np.random.default_rng()
        r = rng.normal(self.params_dict["mu"], self.params_dict["sigma"], size=shape)
        return np.clip(r, self.range_min, self.range_max)


class ClippedStudentTDistr(DistrBase):
    """Standard Student-t(nu) clipped to [range_min, range_max]
    (distributions.py:192-342)."""

    def __init__(self, params_dict, range_min, range_max):
        super().__init__(params_dict, range_min, range_max)
        nu = params_dict["nu"]
        self.point_mass_range_min = stats.t.cdf(range_min, nu)
        self.point_mass_range_max = 1.0 - stats.t.cdf(range_max, nu)

    @property
    def _const(self):
        nu = self.params_dict["nu"]
        return sc.gamma(0.5 * (nu + 1)) / (np.sqrt(np.pi * nu) * sc.gamma(0.5 * nu))

    def i0(self, a, b):
        nu = self.params_dict["nu"]
        return stats.t.cdf(b, nu) - stats.t.cdf(a, nu)

    def i1(self, a, b):
        # antiderivative of x·(1 + x²/nu)^-(nu+1)/2:
        #   nu^((nu+1)/2) (x² + nu)^((1-nu)/2) / (1 - nu)
        nu = self.params_dict["nu"]
        f = lambda x: nu ** ((nu + 1) / 2.0) * (x * x + nu) ** ((1.0 - nu) / 2.0) / (
            1.0 - nu
        )
        return self._const * (f(b) - f(a))

    def i2(self, a, b):
        # antiderivative of x²·(1 + x²/nu)^-(nu+1)/2:
        #   x³/3 · ₂F₁(3/2, (1+nu)/2; 5/2; -x²/nu)
        nu = self.params_dict["nu"]
        f = lambda x: (x**3 / 3.0) * sc.hyp2f1(
            1.5, (1.0 + nu) / 2.0, 2.5, -(x * x) / nu
        )
        return self._const * (f(b) - f(a))

    def pdf(self, x):
        return stats.t.pdf(x, self.params_dict["nu"])

    def cdf(self, x):
        return stats.t.cdf(x, self.params_dict["nu"])

    def sample(self, shape, rng=None):
        rng = rng or np.random.default_rng()
        r = rng.standard_t(self.params_dict["nu"], size=shape)
        return np.clip(r, self.range_min, self.range_max)


class UniformDistr(DistrBase):
    """Uniform on [range_min, range_max] (distributions.py:345-384)."""

    def __init__(self, params_dict=None, range_min=-1.0, range_max=1.0):
        super().__init__(params_dict or {}, range_min, range_max)
        self.p = 1.0 / (self.range_max - self.range_min)

    def i0(self, a, b):
        return self.p * (b - a)

    def i1(self, a, b):
        return self.p * 0.5 * (b * b - a * a)

    def i2(self, a, b):
        return self.p * (b**3 - a**3) / 3.0

    def pdf(self, x):
        return np.full_like(np.asarray(x, float), self.p)

    def cdf(self, x):
        return (np.asarray(x, float) - self.range_min) * self.p

    def sample(self, shape, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.range_min, self.range_max, size=shape)
