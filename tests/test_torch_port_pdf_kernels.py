"""The resampling kernels' plain versions vs the JAX package's kernels.

Kernel #8 (`ops/pdf_merge.py::sample_pdf_merged`, the vanilla fine
level's inverse CDF and merge) and kernel #9 (`mip_resample_t_vals`, the
mip level's blurpool resampler) run their plain versions here and are
held against the JAX kernels in interpret mode on the same numpy-seeded
inputs; so are the routes that reach them (`fine_z_vals(use_kernel=True)`,
`resample_along_rays(use_kernel=True)`) and the order-statistic draws of
`sorted_uniform`. Tolerance 1e-5 on well-conditioned weights (>= 1e-2):
near the 1e-5 pdf floor the inverse CDF magnifies the order of a sum
(ROADMAP Queue 3 item 4). Sortedness and `z_c` inside the merged row are
checked exactly. The ops read their rows through row strides: views
(the interior weights `w[..., 1:-1]`, the expanded linspace of draws)
give the contiguous rows' result, the C entries get the views' strides
(against fake entry points), and rows the kernels cannot take raise.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.core import sampling as jsamp
from consistentnerf_tpu.ops import pdf_merge as jpdf
from consistentnerf_tpu_torch.core import sampling
from consistentnerf_tpu_torch.ops import pdf_merge
from tests.test_torch_port_cuda import inversion_problem
from torch_port_shared import _one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
EPS = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.tensor(np.asarray(x))


def _problem(seed, n, s_c, degenerate=False):
    """Ascending jittered coarse depths in [2, 6] and interior weights
    (>= 1e-2, or all zero)."""
    rs = np.random.RandomState(seed)
    z = np.linspace(2.0, 6.0, s_c, dtype=np.float32)
    z_c = np.sort(z[None] + rs.rand(n, s_c).astype(np.float32)
                  * (4.0 / s_c) * 0.9, -1).astype(np.float32)
    w = (np.zeros((n, s_c - 2)) if degenerate
         else 0.01 + rs.rand(n, s_c - 2)).astype(np.float32)
    return z_c, w


def _uniforms(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _check_merged(got, z_c):
    """Exactly sorted, and every coarse depth present exactly."""
    assert torch.all(got[:, 1:] >= got[:, :-1])
    for r in range(got.shape[0]):
        assert torch.isin(z_c[r], got[r]).all()


def test_sorted_uniform_matches_jax_formula():
    """The order statistics from the same uniforms: ascending, in [0, 1],
    equal to the JAX formula (the JAX function draws its own uniforms
    from a key, so its formula is applied to these)."""
    e = _uniforms(0, (500, 17))
    got = pdf_merge.sorted_uniform(_t(e))
    s = jnp.cumsum(-jnp.log1p(-jnp.asarray(e)), axis=-1)
    want = s[..., :-1] / s[..., -1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (500, 16)
    assert torch.all(got[:, 1:] >= got[:, :-1])
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    det = pdf_merge.fine_z_draws(None, 3, 9, det=True)
    np.testing.assert_array_equal(
        det.numpy(), np.asarray(jpdf.fine_z_draws(None, 3, 9, det=True)))


@pytest.mark.parametrize("n,s_c,s_i,draws,degenerate", [
    (64, 64, 128, "det", False),
    (37, 64, 128, "sorted", False),  # ragged against the JAX row block
    (40, 32, 64, "sorted", False),
    (32, 64, 128, "det", True),  # all-zero weights: the 1e-5 floor
])
def test_plain_sample_pdf_merged_matches_jax(n, s_c, s_i, draws,
                                             degenerate):
    z_c, w = _problem(1, n, s_c, degenerate)
    if draws == "det":
        u = np.asarray(jpdf.fine_z_draws(None, n, s_i, det=True))
    else:
        u = pdf_merge.sorted_uniform(_t(_uniforms(2, (n, s_i + 1)))).numpy()
    want, want_s = jpdf.sample_pdf_merged(jnp.asarray(z_c), jnp.asarray(w),
                                          jnp.asarray(u), interpret=True,
                                          block_rows=16)
    got, got_s = pdf_merge.sample_pdf_merged(_t(z_c), _t(w), _t(u))
    assert got.shape == (n, s_c + s_i) and got_s.shape == (n, s_i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    _check_merged(got, _t(z_c))


@pytest.mark.parametrize("single_jitter,pad", [(None, 0.01), (False, 0.0),
                                               (True, 0.005)])
def test_plain_mip_resample_matches_jax(single_jitter, pad):
    """Deterministic draws (None), per-sample and single jitter; with and
    without padding."""
    n, s = 40, 16
    rs = np.random.RandomState(3)
    t = np.sort(rs.rand(n, s + 1) * 4 + 2, -1).astype(np.float32)
    w = (0.01 + rs.rand(n, s)).astype(np.float32)
    jitter = None
    if single_jitter is not None:
        d = 1 if single_jitter else s + 1
        jitter = _t((rs.rand(n, d) * (1 / (s + 1) - EPS)).astype(
            np.float32))
    u = sampling.piecewise_pdf_draws(jitter, (n,), s + 1).contiguous()
    want = jpdf.mip_resample_t_vals(jnp.asarray(t), jnp.asarray(w),
                                    jnp.asarray(u.numpy()), pad,
                                    interpret=True, block_rows=16)
    got = pdf_merge.mip_resample_t_vals(_t(t), _t(w), u, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.all(got[:, 1:] >= got[:, :-1])
    # Zero weights and zero padding: the eps deficit pad.
    zeros = np.zeros((n, s), np.float32)
    want = jpdf.mip_resample_t_vals(jnp.asarray(t), jnp.asarray(zeros),
                                    jnp.asarray(u.numpy()), 0.0,
                                    interpret=True, block_rows=16)
    got = pdf_merge.mip_resample_t_vals(_t(t), _t(zeros), u, 0.0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("det", [True, False])
def test_fine_z_vals_kernel_route_matches_jax(det):
    """fine_z_vals(use_kernel=True) against the JAX kernel route with the
    same draws, and against the port's own plain route (the merged set is
    the same; the samples come out ascending)."""
    n, s_c, s_i = 30, 16, 24
    z_c, w = _problem(4, n, s_c)
    weights = np.concatenate([np.full((n, 1), 0.3, np.float32), w,
                              np.full((n, 1), 0.2, np.float32)], -1)
    u = None if det else pdf_merge.sorted_uniform(
        _t(_uniforms(5, (n, s_i + 1))))
    got, got_s = pdf_merge.fine_z_vals(_t(z_c), _t(weights), s_i, u=u,
                                       det=det, use_kernel=True,
                                       return_samples=True)
    plain = pdf_merge.fine_z_vals(_t(z_c), _t(weights), s_i, u=u, det=det,
                                  use_kernel=False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    ju = jpdf.fine_z_draws(None, n, s_i, det=True) if det else \
        jnp.asarray(u.numpy())
    want, want_s = jpdf.sample_pdf_merged(
        jnp.asarray(z_c), jnp.asarray(w), ju, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    if det:
        jz = jpdf.fine_z_vals(jnp.asarray(z_c), jnp.asarray(weights), s_i,
                              det=True, use_kernel=True, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jz), **TOL)
    assert not got.requires_grad
    wg = _t(weights).requires_grad_()
    assert not pdf_merge.fine_z_vals(_t(z_c), wg, s_i, u=u, det=det,
                                     use_kernel=True).requires_grad


@pytest.mark.parametrize("single_jitter", [None, False, True])
def test_resample_along_rays_kernel_route_matches_jax(single_jitter):
    """resample_along_rays(use_kernel=True) against the JAX kernel route
    with the same draw stream, and against the port's plain route."""
    n, s = 24, 16
    rs = np.random.RandomState(6)
    o = rs.randn(n, 3).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    radii = np.full((n, 1), 1e-3, np.float32)
    t = np.sort(rs.rand(n, s + 1) * 4 + 2, -1).astype(np.float32)
    w = (0.01 + rs.rand(n, s)).astype(np.float32)
    rng = jax.random.PRNGKey(7) if single_jitter is not None else None
    jitter = None
    if rng is not None:
        dd = 1 if single_jitter else s + 1
        jitter = _t(jax.random.uniform(rng, (n, dd),
                                       maxval=1 / (s + 1) - EPS))
    args = (_t(o), _t(d), _t(radii), _t(t), _t(w), "cone", True, 0.01)
    t_k, (m_k, c_k) = sampling.resample_along_rays(jitter, *args,
                                                   use_kernel=True)
    t_p, (m_p, c_p) = sampling.resample_along_rays(jitter, *args)
    np.testing.assert_allclose(t_k.numpy(), t_p.numpy(), **TOL)
    np.testing.assert_allclose(m_k.numpy(), m_p.numpy(), **TOL)
    jt, (jm, jc) = jsamp.resample_along_rays(
        rng, *[jnp.asarray(x) for x in (o, d, radii, t, w)], "cone", True,
        0.01, bool(single_jitter), use_kernel=True)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(m_k.numpy(), np.asarray(jm), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(c_k.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-4)


CSRC = Path(__file__).resolve().parents[1] / "consistentnerf_tpu_torch" / \
    "csrc"


def _c_kinds(source, symbol):
    """The parameter kinds of `extern "C" int symbol(...)` in csrc/source:
    p a pointer, i an int, f a float."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, f"{symbol} is not declared in {source}"
    return "".join("p" if "*" in p else p.split()[0][0]
                   for p in m.group(1).split(","))


@pytest.mark.parametrize("draws", ["det", "sorted"])
def test_sample_pdf_merged_takes_views(draws):
    """#8's op on the callers' views (the interior weights of the full
    row, the expanded linspace or a slice of wider draws) gives the
    contiguous rows' result, and the JAX kernel's."""
    n, s_c, s_i = 21, 32, 48
    z_c, w = _problem(7, n, s_c)
    full = np.concatenate([np.full((n, 1), 0.4, np.float32), w,
                           np.full((n, 1), 0.1, np.float32)], -1)
    if draws == "det":
        u_view = pdf_merge.fine_z_draws(None, n, s_i, True)
    else:
        u_view = pdf_merge.sorted_uniform(_t(_uniforms(8, (n, s_i + 4))))[
            :, :s_i]
    w_view = _t(full)[:, 1:-1]
    assert w_view.stride(0) == s_c and not u_view.is_contiguous()
    got, got_s = pdf_merge.sample_pdf_merged(_t(z_c), w_view, u_view)
    want, want_s = pdf_merge.sample_pdf_merged(_t(z_c), _t(w),
                                               u_view.contiguous())
    assert torch.equal(got, want) and torch.equal(got_s, want_s)
    jm, js = jpdf.sample_pdf_merged(jnp.asarray(z_c), jnp.asarray(w),
                                    jnp.asarray(u_view.numpy()),
                                    interpret=True, block_rows=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), **TOL)
    _check_merged(got, _t(z_c))


def test_mip_resample_takes_views():
    """#9's op on views (fenceposts and weights sliced from wider rows,
    the expanded deterministic draws) gives the contiguous rows' result,
    and the JAX kernel's."""
    n, s = 19, 24
    rs = np.random.RandomState(9)
    t = np.sort(rs.rand(n, s + 1) * 4 + 2, -1).astype(np.float32)
    w = (0.01 + rs.rand(n, s)).astype(np.float32)
    u_view = sampling.piecewise_pdf_draws(None, (n,), s + 1)
    t_view = torch.cat([_t(t), _t(t)], 1)[:, :s + 1]
    w_view = torch.cat([_t(w), _t(w)], 1)[:, s:]
    assert u_view.stride(0) == 0 and w_view.stride(0) == 2 * s
    got = pdf_merge.mip_resample_t_vals(t_view, w_view, u_view, 0.01)
    want = pdf_merge.mip_resample_t_vals(_t(t), _t(w), u_view.contiguous(),
                                         0.01)
    assert torch.equal(got, want)
    jt = jpdf.mip_resample_t_vals(jnp.asarray(t), jnp.asarray(w),
                                  jnp.asarray(u_view.numpy()), 0.01,
                                  interpret=True, block_rows=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jt), **TOL)


def _bad(t, fault):
    if fault == "last stride":
        return torch.cat([t, t], -1)[..., ::2]
    if fault == "dtype":
        return t.double()
    return t.to("meta")


@pytest.mark.parametrize("arg", [0, 1, 2])
@pytest.mark.parametrize("fault", ["last stride", "dtype", "device"])
def test_ops_refuse_rows_they_cannot_take(arg, fault):
    """Both ops raise for an input whose last dimension is not
    unit-stride, that is not fp32, or that lies on another device than
    the first input, on every device."""
    n = 6
    z_c, w = _problem(10, n, 16)
    pdf_in = [_t(z_c), _t(w), pdf_merge.fine_z_draws(None, n, 20, True)]
    t = np.sort(np.random.RandomState(11).rand(n, 9) * 4 + 2,
                -1).astype(np.float32)
    mip_in = [_t(t), torch.rand(n, 8),
              sampling.piecewise_pdf_draws(None, (n,), 9)]
    pdf_in[arg] = _bad(pdf_in[arg], fault)
    mip_in[arg] = _bad(mip_in[arg], fault)
    with pytest.raises(ValueError):
        pdf_merge.sample_pdf_merged(*pdf_in)
    with pytest.raises(ValueError):
        pdf_merge.mip_resample_t_vals(*mip_in, 0.01)


@pytest.mark.parametrize("kernel", ["pdf_merge", "mip_resample"])
def test_launch_hands_the_c_entry_its_row_strides(monkeypatch, kernel):
    """The launchers against fake entry points: the argument kinds of the
    C declarations in csrc/, the views' pointers and row strides (the
    interior weights of a full row, fenceposts from a wider row, draws
    with row stride 0), the sizes and the launch count."""
    calls = []

    def fake():
        return lambda *a: calls.append(a) or 0

    n = 5
    if kernel == "pdf_merge":
        assert _c_kinds("pdf_merge.cu", kernel) == pdf_merge.PDF_ARGS
        monkeypatch.setattr(pdf_merge, "_kernel", fake)
        z_c, full = torch.rand(n, 8), torch.rand(n, 8)
        ins = (z_c, full[:, 1:-1], pdf_merge.fine_z_draws(None, n, 6, True))
        strides = [pdf_merge.row_stride(k, x, n, x.shape[1], z_c.device)
                   for k, x in zip("zwu", ins)]
        outs = (torch.empty(n, 14), torch.empty(n, 6))
        before = pdf_merge.launches
        pdf_merge.pdf_merge_launch(*ins, *outs, strides, 0)
        assert pdf_merge.launches == before + 1
        want = (z_c.data_ptr(), 8, full.data_ptr() + 4, 8,
                ins[2].data_ptr(), 0, outs[0].data_ptr(),
                outs[1].data_ptr(), n, 8, 6, 0)
    else:
        assert _c_kinds("mip_resample.cu", kernel) == pdf_merge.MIP_ARGS
        monkeypatch.setattr(pdf_merge, "_mip_kernel", fake)
        wide = torch.rand(n, 20)
        ins = (wide[:, :10], torch.rand(n, 9),
               sampling.piecewise_pdf_draws(None, (n,), 10))
        strides = [pdf_merge.row_stride(k, x, n, x.shape[1], wide.device)
                   for k, x in zip("twu", ins)]
        out = torch.empty(n, 10)
        before = pdf_merge.mip_launches
        pdf_merge.mip_resample_launch(*ins, out, strides, 0.25, 0)
        assert pdf_merge.mip_launches == before + 1
        want = (wide.data_ptr(), 20, ins[1].data_ptr(), 9,
                ins[2].data_ptr(), 0, out.data_ptr(), n, 9, 0.25, 0)
    assert calls == [want]


def test_inversion_rows_invert_the_plain_samples():
    """The card test's fix-up rows (`inversion_problem`): the plain
    samples come out inverted in some rows, the merged rows stay sorted,
    and the JAX kernel gives the same merged rows."""
    z_c, w, u = inversion_problem(20000)
    merged, z_s = pdf_merge.sample_pdf_merged(z_c, w, u)
    assert int((z_s[:, 1] < z_s[:, 0]).sum()) > 0
    assert torch.all(merged[:, 1:] >= merged[:, :-1])
    jm, _ = jpdf.sample_pdf_merged(*[jnp.asarray(x.numpy())
                                     for x in (z_c, w, u)],
                                   interpret=True, block_rows=16)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("single_jitter", [None, True])
def test_plain_mip_resample_takes_one_sample(single_jitter):
    """One weight (two fenceposts): the cdf is [0, 1], as the JAX
    kernel's and the JAX package's sorted_piecewise_constant_pdf make it
    (the port's inverse_cdf once built an empty cdf from an empty
    cumsum)."""
    n = 12
    rs = np.random.RandomState(12)
    t = np.sort(rs.rand(n, 2) * 4 + 2, -1).astype(np.float32)
    w = (0.01 + rs.rand(n, 1)).astype(np.float32)
    jitter = None if single_jitter is None else _t(
        (rs.rand(n, 1) * (0.5 - EPS)).astype(np.float32))
    u = sampling.piecewise_pdf_draws(jitter, (n,), 2)
    got = pdf_merge.mip_resample_t_vals(_t(t), _t(w), u, 0.01)
    want = jpdf.mip_resample_t_vals(jnp.asarray(t), jnp.asarray(w),
                                    jnp.asarray(u.numpy()), 0.01,
                                    interpret=True, block_rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if jitter is None:
        jt = jsamp.sorted_piecewise_constant_pdf(
            None, jnp.asarray(t), jnp.asarray(w) + 0.01, 2)
        got_p = sampling.sorted_piecewise_constant_pdf(_t(t), _t(w) + 0.01,
                                                       2)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(jt), **TOL)
