"""The port's mip core functions vs the JAX package's, on the same numpy
inputs at fp32 (atol 1e-5): spacing, the mip encodings, cone casting,
the hardened inverse CDF and the resampling, the alpha weights and the
rendering dict, and the lr / padding schedules. Random draws are made by
JAX from its keys and handed to the port as tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.core import encoding as jenc
from consistentnerf_tpu.core import mathx as jmathx
from consistentnerf_tpu.core import mip as jmip
from consistentnerf_tpu.core import rendering as jrend
from consistentnerf_tpu.core import sampling as jsamp
from consistentnerf_tpu.core import spacing as jspace
from consistentnerf_tpu_torch.core import encoding, mathx, mip, rendering
from consistentnerf_tpu_torch.core import sampling, spacing
from torch_port_shared import _one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
EPS = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def rays():
    rs = np.random.RandomState(0)
    n = 17
    d = rs.randn(n, 3).astype(np.float32)
    o = (-4 * d / np.linalg.norm(d, axis=1, keepdims=True)
         + 0.1 * rs.randn(n, 3)).astype(np.float32)
    radii = (0.002 + 0.003 * rs.rand(n, 1)).astype(np.float32)
    near = np.full((n, 1), 2.0, np.float32)
    far = np.full((n, 1), 6.0, np.float32)
    return o, d, radii, near, far


@pytest.mark.parametrize("fn", [None, "linear", "log", "reciprocal"])
def test_genspace(fn):
    start = np.array([[2.0], [1.5]], np.float32)
    stop = np.array([[6.0], [4.0]], np.float32)
    _close(spacing.genspace(_t(start), _t(stop), 9, fn),
           jspace.genspace(start, stop, 9, fn))
    assert spacing.resolve_curve(fn)[0] is not None


def test_encodings_with_range_reduction():
    rs = np.random.RandomState(1)
    # |x| up to 8 with 16 frequencies: x 2^15 passes 100 pi, where the
    # floor-mod range reduction of safe_sin decides the value.
    x = (rs.rand(64, 3) * 16 - 8).astype(np.float32)
    var = (rs.rand(64, 3) * 1e-6).astype(np.float32)
    _close(encoding.pos_enc(_t(x), 0, 4), jenc.pos_enc(x, 0, 4, True))
    _close(encoding.pos_enc(_t(x), 0, 4, append_identity=False),
           jenc.pos_enc(x, 0, 4, False))
    _close(encoding.expected_sin(_t(x), _t(var)), jenc.expected_sin(x, var))
    _close(encoding.integrated_pos_enc(_t(x), _t(var), 0, 16),
           jenc.integrated_pos_enc((x, var), 0, 16), atol=2e-5, rtol=1e-5)
    assert np.abs(x * 2.0**15).max() > 100 * np.pi


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0])
def test_full_covariance_ipe_matches_jax(scale):
    """The full-covariance IPE (`diag=False`) on seeded means and seeded
    symmetric positive definite covariances, against the JAX function."""
    rs = np.random.RandomState(4)
    x = (rs.rand(2, 32, 3) * 8 - 4).astype(np.float32)
    a = rs.randn(2, 32, 3, 3)
    cov = (scale * (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3))).astype(
        np.float32)
    want = jenc.integrated_pos_enc((x, cov), 0, 16, diag=False)
    _close(encoding.integrated_pos_enc(_t(x), _t(cov), 0, 16, diag=False),
           want, atol=2e-5, rtol=1e-5)
    _close(encoding.integrated_pos_enc(_t(x), _t(cov), 2, 10, diag=False),
           jenc.integrated_pos_enc((x, cov), 2, 10, diag=False), atol=2e-5,
           rtol=1e-5)


@pytest.mark.parametrize("shape", ["cone", "cylinder"])
def test_cast_rays_both_layouts(rays, shape):
    o, d, radii, near, far = rays
    t = np.sort(np.random.RandomState(2).rand(o.shape[0], 9) * 4 + 2,
                -1).astype(np.float32)
    for transposed in (False, True):
        got = mip.cast_rays(_t(t), _t(o), _t(d), _t(radii), shape,
                            transposed=transposed)
        want = jmip.cast_rays(t, o, d, radii, shape, transposed=transposed)
        for a, b in zip(got, want):
            _close(a, b, atol=1e-5, rtol=1e-4)
    # The unstable closed form (stable=False, on no path of either
    # package) cancels catastrophically in fp32; it is held against the
    # stable one in fp64, where both are exact to ~1e-9.
    t64, d64, r64 = (torch.from_numpy(x).double() for x in (t, d, radii))
    stable = mip.conical_frustum_to_gaussian(d64, t64[:, :-1], t64[:, 1:],
                                             r64, True, stable=True)
    closed = mip.conical_frustum_to_gaussian(d64, t64[:, :-1], t64[:, 1:],
                                             r64, True, stable=False)
    for a, b in zip(closed, stable):
        _close(a, b, atol=1e-9, rtol=1e-6)
    full = mip.lift_gaussian(_t(d), _t(t[:, :-1]), _t(t[:, 1:] * 0.01),
                             _t(t[:, 1:] * 0.001), diag=False)
    jfull = jmip.lift_gaussian(d, t[:, :-1], t[:, 1:] * 0.01,
                               t[:, 1:] * 0.001, diag=False)
    for a, b in zip(full, jfull):
        _close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("randomized", [False, True])
def test_sample_and_resample_along_rays(rays, randomized):
    """Level 0's stratified fenceposts and level 1's blurpool resampling
    through the hardened inverse CDF, with JAX's draws."""
    o, d, radii, near, far = rays
    n, s = o.shape[0], 12
    key = jax.random.PRNGKey(3) if randomized else None
    t_j, (m_j, c_j) = jsamp.sample_along_rays(
        key, o, d, radii, s, near, far, None, "cone", False,
        transposed=True)
    t_rand = (_t(jax.random.uniform(key, (n, s + 1))) if randomized
              else None)
    t_p, (m_p, c_p) = sampling.sample_along_rays(
        t_rand, _t(o), _t(d), _t(radii), s, _t(near), _t(far), None,
        "cone", transposed=True)
    for a, b in ((t_p, t_j), (m_p, m_j), (c_p, c_j)):
        _close(a, b, atol=1e-5, rtol=1e-4)
    w = np.random.RandomState(4).rand(n, s).astype(np.float32)
    w[0] = 0.0  # a ray with no weight: the eps padding of the pdf
    key2 = jax.random.PRNGKey(5) if randomized else None
    t2_j, (m2_j, _) = jsamp.resample_along_rays(
        key2, o, d, radii, np.asarray(t_j), w, "cone", True, 0.01, False)
    jitter = (_t(jax.random.uniform(key2, (n, s + 1),
                                    maxval=1 / (s + 1) - EPS))
              if randomized else None)
    t2_p, (m2_p, _) = sampling.resample_along_rays(
        jitter, _t(o), _t(d), _t(radii), t_p, _t(w), "cone", True, 0.01)
    _close(t2_p, t2_j, atol=1e-5, rtol=1e-4)
    _close(m2_p, m2_j, atol=1e-5, rtol=1e-4)


def test_piecewise_draws_and_single_jitter():
    key = jax.random.PRNGKey(6)
    for single in (False, True):
        d = 1 if single else 7
        jit = jax.random.uniform(key, (5, d), maxval=1 / 7 - EPS)
        _close(sampling.piecewise_pdf_draws(_t(jit), (5,), 7),
               jsamp.piecewise_pdf_draws(key, (5,), 7, single))
    _close(sampling.piecewise_pdf_draws(None, (5,), 7),
           jsamp.piecewise_pdf_draws(None, (5,), 7, False))
    # The kernel route (#9, its plain version here) takes the same draws.
    rs = np.random.RandomState(8)
    t = np.sort(rs.rand(5, 8) * 4 + 2, -1).astype(np.float32)
    w = (0.01 + rs.rand(5, 7)).astype(np.float32)
    jit = jax.random.uniform(key, (5, 1), maxval=1 / 8 - EPS)
    args = (*[_t(rs.randn(5, 3).astype(np.float32))] * 2,
            _t(np.full((5, 1), 1e-3, np.float32)), _t(t), _t(w), "cone",
            True, 0.01)
    for j in (None, _t(jit)):
        t_k, (m_k, _) = sampling.resample_along_rays(j, *args,
                                                     use_kernel=True)
        t_p, (m_p, _) = sampling.resample_along_rays(j, *args)
        _close(t_k, t_p)
        _close(m_k, m_p)


def test_alpha_weights_and_volumetric_rendering(rays):
    o, d, *_ = rays
    rs = np.random.RandomState(7)
    n, s = o.shape[0], 10
    t = np.sort(rs.rand(n, s + 1) * 4 + 2, -1).astype(np.float32)
    dens = (rs.rand(n, s) * 3).astype(np.float32)
    dens[1] = 0.0  # no weight at all: distance_mean falls back to t_S
    rgb = rs.rand(n, s, 3).astype(np.float32)
    got = rendering.compute_alpha_weights(_t(dens), _t(t), _t(d))
    want = jrend.compute_alpha_weights(dens, t, d)
    for a, b in zip(got, want):
        _close(a, b)
    w = np.asarray(want[0])
    normals = rs.randn(n, s, 3).astype(np.float32)
    jr = jrend.volumetric_rendering(rgb, w, normals, t, True, 4, True,
                                    want[3])
    for rgbs, rgbs_T in ((_t(rgb), None), (None, _t(rgb).permute(2, 0, 1))):
        pr = rendering.volumetric_rendering(rgbs, _t(w), _t(normals), _t(t),
                                            True, 4, True, rgbs_T=rgbs_T)
        for k in ("rgb", "distance_mean", "acc", "normals",
                  "distance_mean_save",
                  "distance_std", "distance_median", "distance_percentile_5",
                  "distance_percentile_95", "ray_t_vals", "ray_weights",
                  "ray_rgbs"):
            _close(pr[k], jr[k], err_msg=k, atol=2e-5, rtol=1e-5)
    assert pr["distance_mean"][1].item() == t[1, -1]


def test_schedules_and_percentiles():
    for step in (0, 100, 511, 512, 4000, 50000):
        np.testing.assert_allclose(
            mathx.learning_rate_decay(step, 2e-3, 2e-5, 50000, 512, 0.01),
            float(jmathx.learning_rate_decay(step, 2e-3, 2e-5, 50000, 512,
                                             0.01)), rtol=1e-6)
        np.testing.assert_allclose(
            mathx.log_lerp(step / 50000, 0.01, 0.001),
            float(jmathx.log_lerp(step / 50000, 0.01, 0.001)), rtol=1e-6)
    rs = np.random.RandomState(8)
    x = np.sort(rs.rand(6, 9), -1).astype(np.float32)
    w = rs.rand(6, 9).astype(np.float32)
    w[2, 3:] = 0.0
    want = np.stack([np.asarray(jmathx.weighted_percentile(
        x[i], w[i], [5, 50, 95], assume_sorted=True)) for i in range(6)])
    _close(mathx.weighted_percentile(_t(x), _t(w), [5, 50, 95],
                                     assume_sorted=True), want)
    xu = rs.rand(9).astype(np.float32)
    _close(mathx.weighted_percentile(_t(xu)[None], _t(w[0])[None], [50])[0],
           jmathx.weighted_percentile(xu, w[0], [50]))
