"""The mip kernels' plain versions and packed walks vs the JAX package.

Kernel #6 (`ops/fused_mip.py::fwd_T`, the MipMLP forward) is held against
the JAX `_fwd_pallas_T` and `reference_mip_mlp_apply`, kernel #7
(`fused_mip.bwd_T`, its weight grads) against `_bwd_pallas_T`, and
kernel #5 (`ops/fused_onepass.py::onepass_mip_level_T`, the one-pass mip
level) against the JAX `onepass_mip_level_T`, the JAX kernels in
interpret mode. Sizes follow the JAX package's tests: depth 2 and width
64 with 4 IPE frequencies, and the production depth 8 (skip after layer
4) with 16 frequencies at width 64; the view layer is 128 wide, as the
MipMLP's always is. On the CPU the port's wrappers run the plain
versions; the packed walks follow the CUDA kernels' buffers and rounding,
so their layout is proved here before any card runs them. Each JAX
reference is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CONFIGS = {"d2": (2, 64, 4), "d8": (8, 64, 16)}  # depth, width, freqs
FWD_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = 2e-2  # max |port - JAX| / mean |JAX| at bf16
DW_REL = 1e-4  # ||dW(port) - dW(JAX)|| / ||dW(JAX)|| per tensor, fp32
ROWS_TOL = 1e-5


def _mlp(name):
    """Seeded JAX MipMLP params as the JAX flat list and the port's."""
    depth, width, nf = CONFIGS[name]
    m = JaxMipMLP(net_depth=depth, net_width=width, max_deg_point=nf,
                  disable_normals=True)
    z = jnp.zeros((2, 3))
    params = m.init(jax.random.PRNGKey(0), None, (z, z), z)
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(params, depth)]
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = [sd[f"mlp.dense.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}"]
            for i in range(2 * (depth + 4))]
    return jflat, flat


def _streams(n, seed):
    rs = np.random.RandomState(seed)
    means = (rs.rand(3, n) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(3, n) * 1e-3).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    return means, covs, views


def _jax_layout(port_grads):
    """Port (torch [out, in], biases [C]) -> JAX ([in, out], [C])."""
    return [g.numpy().T if g.ndim == 2 else g.numpy() for g in port_grads]


def _assert_rel(got, want, tol):
    for i, (a, b) in enumerate(zip(_jax_layout(got), want)):
        b = np.asarray(b, np.float64).reshape(a.shape)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < tol, f"weight {i}: rel L2 {rel:.3e}"


# ----------------------------- kernel #6 ---------------------------------


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fwd_case(request):
    return once_per_run(request, lambda: _fwd_case(request.param))


def _fwd_case(name):
    depth, _, nf = CONFIGS[name]
    jflat, flat = _mlp(name)
    n = 200  # not a multiple of the JAX tile
    m, c, v = _streams(n, 1)
    want = {dt: np.asarray(jfmip._fwd_pallas_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v), depth, 4, nf,
        4, 128, True, dt)) for dt in (jnp.float32, jnp.bfloat16)}
    ref = np.asarray(jfmip.reference_mip_mlp_apply(
        jflat, m.T, c.T, v.T, net_depth=depth, num_freqs=nf))
    return name, flat, [torch.from_numpy(x) for x in (m, c, v)], want, ref


def test_plain_fwd_matches_jax_fwd_kernel(fwd_case):
    name, flat, (m, c, v), want, ref = fwd_case
    depth, _, nf = CONFIGS[name]
    got = fmip.fwd_T(flat, m, c, v, depth, nf, "float32")
    np.testing.assert_allclose(got.numpy(), want[jnp.float32], **FWD_TOL)
    np.testing.assert_allclose(
        fmip.reference_mip_mlp_apply(flat, m.T, c.T, v.T, net_depth=depth,
                                     num_freqs=nf).numpy(), ref, **FWD_TOL)
    got16 = fmip.fwd_T(flat, m, c, v, depth, nf, "bfloat16")
    b = want[jnp.bfloat16]
    assert np.abs(got16.numpy() - b).max() / np.abs(b).mean() < BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_fwd_walk_matches_jax_fwd_kernel(fwd_case, dtype):
    """The CUDA kernels' walk over their packed buffers: the post-skip
    rows reordered to [pe | h], the view rows [bottleneck | v, sin, cos]."""
    name, flat, (m, c, v), want, _ = fwd_case
    depth, _, nf = CONFIGS[name]
    packed = fmip.pack(flat, depth, nf, dtype)
    got = v2.packed_reference_T(packed, m, v, c).numpy()
    b = want[jnp.float32 if dtype == "float32" else jnp.bfloat16]
    if dtype == "float32":
        np.testing.assert_allclose(got, b, **FWD_TOL)
    else:
        assert np.abs(got - b).max() / np.abs(b).mean() < BF16_TOL


# ----------------------------- kernel #7 ---------------------------------


@pytest.fixture(scope="module")
def bwd_case(request):
    return once_per_run(request, _bwd_case)


def _bwd_case():
    depth, _, nf = CONFIGS["d8"]
    jflat, flat = _mlp("d8")
    n = 160
    m, c, v = _streams(n, 2)
    g = np.random.RandomState(3).randn(4, n).astype(np.float32)
    want = [np.asarray(x) for x in jfmip._bwd_pallas_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v),
        jnp.asarray(g), depth, 4, nf, 4, 128, True, jnp.float32)]
    return flat, [torch.from_numpy(x) for x in (m, c, v, g)], want


def test_plain_bwd_matches_jax_bwd_kernel(bwd_case):
    flat, (m, c, v, g), want = bwd_case
    depth, _, nf = CONFIGS["d8"]
    got = fmip.bwd_T(flat, m, c, v, g, depth, nf, "float32")
    assert [x.shape for x in got] == [w.shape for w in flat]
    _assert_rel(got, want, DW_REL)


def test_packed_bwd_walk_matches_jax_bwd_kernel(bwd_case):
    flat, (m, c, v, g), want = bwd_case
    depth, _, nf = CONFIGS["d8"]
    packed = fmip.pack(flat, depth, nf, "float32")
    _assert_rel(v2.packed_bwd_reference_T(packed, m, v, g, c), want, DW_REL)


def test_train_op_autograd_matches_plain_bwd(bwd_case):
    """fused_mip_mlp_train_T: forward fwd_T, backward bwd_T (CPU:
    plain)."""
    flat, (m, c, v, g), _ = bwd_case
    depth, _, nf = CONFIGS["d8"]
    leaves = [w.clone().requires_grad_() for w in flat]
    raw = fmip.fused_mip_mlp_train_T(leaves, m, c, v, depth, nf, "float32")
    raw.backward(g)
    want = fmip.plain_bwd_T(flat, m, c, v, g, depth, nf, "float32")
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b)
    # The normals variant (6n) is ported: its raw heads are the forward's,
    # rows 4-6 the density's gradient by the means (held against the JAX
    # kernel in test_torch_port_mip_normals.py); here against autograd
    # through the whole plain forward, the IPE included.
    rows = fmip.fused_mip_mlp_normals_T(flat, m, c, v, depth, nf, "float32")
    torch.testing.assert_close(rows[:4], fmip.fwd_T(flat, m, c, v, depth,
                                                    nf, "float32"))
    means = m.clone().requires_grad_()
    raw = fmip.plain_fwd_T(flat, means, c, v, depth, nf, "float32")
    dmeans, = torch.autograd.grad(raw[3].sum(), means)
    torch.testing.assert_close(rows[4:], dmeans, rtol=1e-5,
                               atol=1e-5 * dmeans.abs().max().item())


# ----------------------------- kernel #5 ---------------------------------


def _level_inputs(n_rays, seg, seed):
    rs = np.random.RandomState(seed)
    m, c, v = _streams(n_rays * seg, seed)
    v = np.repeat(v[:, :n_rays], seg, 1)
    t = np.sort(rs.rand(n_rays, seg + 1) * 4 + 2, -1).astype(np.float32)
    dn = (0.5 + rs.rand(n_rays)).astype(np.float32)
    rows = dict(
        tmid=0.5 * (t[:, 1:] + t[:, :-1]),
        delta=(t[:, 1:] - t[:, :-1]) * dn[:, None],
        tlo=t[:, 0], thi=t[:, -1],
        crgb=rs.rand(n_rays).astype(np.float32),
        tgt=rs.rand(n_rays, 3).astype(np.float32),
        cd=rs.rand(n_rays).astype(np.float32),
        prior=(rs.rand(n_rays) * 4 + 2).astype(np.float32),
        noise=rs.randn(n_rays, seg).astype(np.float32))
    return (m, c, v), rows


@pytest.fixture(scope="module", params=["noise", "no_noise"])
def level_case(request):
    return once_per_run(request, lambda: _level_case(request.param))


def _level_case(noise_case):
    depth, _, nf = CONFIGS["d2"]
    jflat, flat = _mlp("d2")
    n_rays, seg = 12, 16
    (m, c, v), rows = _level_inputs(n_rays, seg, 5)
    noise = rows["noise"] if noise_case == "noise" else None

    def rep(x):
        x = np.asarray(x, np.float32)
        x = x[:, None] if x.ndim == 1 else x
        return jnp.asarray(np.repeat(x.T, seg, 1))

    out_rows, dws = jop.onepass_mip_level_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v),
        jnp.asarray(rows["tmid"].reshape(1, -1)),
        jnp.asarray(rows["delta"].reshape(1, -1)), rep(rows["tlo"]),
        rep(rows["thi"]), rep(rows["crgb"]), rep(rows["tgt"]),
        rep(rows["cd"]), rep(rows["prior"]),
        None if noise is None else jnp.asarray(noise.reshape(1, -1)),
        seg=seg, net_depth=depth, num_freqs=nf, white_bkgd=True,
        interpret=True, tile=256, compute_dtype=jnp.float32)
    port = {k: torch.from_numpy(x) for k, x in rows.items()}
    port["noise"] = None if noise is None else port["noise"]
    return flat, [torch.from_numpy(x) for x in (m, c, v)], port, (
        np.asarray(out_rows), [np.asarray(x) for x in dws])


def _level_args(port):
    return (port["tmid"], port["delta"], port["tlo"], port["thi"],
            port["crgb"], port["tgt"], port["cd"], port["prior"],
            port["noise"])


def test_plain_level_matches_jax_level_kernel(level_case):
    flat, (m, c, v), port, (want_rows, want_dw) = level_case
    depth, _, nf = CONFIGS["d2"]
    rows, dw = op.onepass_mip_level(flat, m, c, v, *_level_args(port),
                                    net_depth=depth, num_freqs=nf,
                                    white_bkgd=True)
    np.testing.assert_allclose(rows.numpy(), want_rows, atol=ROWS_TOL,
                               rtol=ROWS_TOL)
    _assert_rel(dw, want_dw, DW_REL)


def test_packed_level_walk_matches_jax_level_kernel(level_case):
    """The mip level kernel's walk: packed forward, the compositing with
    its explicit VJP, packed backward."""
    flat, (m, c, v), port, (want_rows, want_dw) = level_case
    depth, _, nf = CONFIGS["d2"]
    packed = fmip.pack(flat, depth, nf, "float32")
    rows, dw = op.packed_onepass_mip_reference(
        packed, m, c, v, *_level_args(port), white_bkgd=True)
    np.testing.assert_allclose(rows.numpy(), want_rows, atol=ROWS_TOL,
                               rtol=ROWS_TOL)
    _assert_rel(dw, want_dw, DW_REL)


def test_level_rows_signature_matches_per_ray_form(level_case):
    """onepass_mip_level_T (the JAX row signature) is onepass_mip_level
    on the per-ray values."""
    flat, (m, c, v), port, _ = level_case
    depth, _, nf = CONFIGS["d2"]
    seg = port["tmid"].shape[1]

    def rep(x):
        x = x[:, None] if x.ndim == 1 else x
        return x.T.repeat_interleave(seg, 1)

    noise = port["noise"]
    rows_t, dw_t = op.onepass_mip_level_T(
        flat, m, c, v, port["tmid"].reshape(1, -1),
        port["delta"].reshape(1, -1), rep(port["tlo"]), rep(port["thi"]),
        rep(port["crgb"]), rep(port["tgt"]), rep(port["cd"]),
        rep(port["prior"]),
        None if noise is None else noise.reshape(1, -1), seg=seg,
        net_depth=depth, num_freqs=nf, white_bkgd=True)
    rows, dw = op.onepass_mip_level(flat, m, c, v, *_level_args(port),
                                    net_depth=depth, num_freqs=nf,
                                    white_bkgd=True)
    assert torch.equal(rows_t, rows)
    assert all(torch.equal(a, b) for a, b in zip(dw_t, dw))


def test_degenerate_rays_in_the_level(level_case):
    """A ray with no density (acc 0: distance_mean is t_S and gets no
    cotangent) and one whose distance is clipped: the packed walk's
    explicit VJP agrees with autograd through the plain version."""
    flat, (m, c, v), port, _ = level_case
    depth, _, nf = CONFIGS["d2"]
    port = dict(port)
    port["delta"] = port["delta"].clone()
    port["delta"][0] = 0.0  # no weight at all on ray 0
    port["tlo"] = port["tlo"].clone()
    port["tlo"][1] = port["thi"][1] - 1e-3  # ray 1 clipped from below
    packed = fmip.pack(flat, depth, nf, "float32")
    rows_w, dw_w = op.packed_onepass_mip_reference(
        packed, m, c, v, *_level_args(port), white_bkgd=True)
    rows_p, dw_p = op.plain_onepass_mip_level(
        flat, m, c, v, *_level_args(port), net_depth=depth, num_freqs=nf,
        white_bkgd=True, compute_dtype=torch.float32)
    seg = port["tmid"].shape[1]
    assert rows_w[3, 0].item() == port["thi"][0].item()
    assert rows_w[4, 0].item() == 0.0
    assert rows_w[3, seg].item() == pytest.approx(port["tlo"][1].item())
    torch.testing.assert_close(rows_w, rows_p, atol=1e-5, rtol=1e-5)
    for a, b in zip(dw_w, dw_p):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
