"""The row-major kernels' plain versions and ops vs the JAX package.

Kernel #10 (`ops/fused_mlp_v2.py::fwd`, the NeRF MLP forward on [N, 3]
streams) is held against the JAX `_fwd_pallas`, kernel #11 (`bwd`, its
weight grads) against the grads of the JAX `fused_mlp_v2_train`, and
`hybrid_mlp_v2_train` (plain forward, #11) against the JAX op of that
name, at depth 4, width 32, skip after layer 2, multires 4 / 2. Kernels
#15 / #16 (`ops/fused_mip.py::fwd` / `bwd`) and the op
`fused_mip_mlp_train` are held against the JAX `fused_mip_mlp_train`,
forward and weight grads, at the mip kernel tests' production depth (8,
16 IPE frequencies, width 64). The `v2row` and `v2h` fused renders are
held against the JAX `fused_render_rays`, and so are the "v1" and
"hybrid" renders (kernel #12). The JAX kernels run in
interpret mode; on the CPU the port's wrappers run the plain versions.
The v1 kinds' renders (#12) are held here too, beside the v2 ones.
The row-major kernels run the transposed kernels' walks, so at bf16 the
packed walk over the transposed streams is their reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.models.nerf import VanillaNeRF as JaxVanillaNeRF
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_v2 as jv2
from consistentnerf_tpu.ops import fused_render as jfr
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_render
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

DEPTH, WIDTH, SKIPS, MR, MV = 4, 32, (2,), 4, 2
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
DW_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = 2e-2  # max |port - JAX| / mean |JAX|: #1's and #2's bf16 bound
MIP_FWD_TOL = dict(atol=5e-4, rtol=5e-4)  # the mip kernel tests' bounds
MIP_DW_REL = 1e-4


def _jax_layout(port_grads):
    """Port (torch [out, in], biases [C]) -> JAX ([in, out], flat)."""
    return [g.numpy().T if g.ndim == 2 else g.numpy() for g in port_grads]


def _assert_grads(got, want, **tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(_jax_layout(got), want)):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   err_msg=f"weight {i}", **tol)


# --------------------------- kernels #10, #11 -----------------------------


@pytest.fixture(scope="module")
def nerf_case(request):
    """Seeded NeRFMLP weights in both layouts, [N, 3] streams and a
    cotangent, and the JAX row-major kernels' outputs and grads."""
    return once_per_run(request, _nerf_case)


def _nerf_case():
    m = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS)
    pe, ve = 3 * (1 + 2 * MR), 3 * (1 + 2 * MV)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, pe)),
                    jnp.zeros((2, ve)))
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfm.flatten_params(params, True, DEPTH)]
    jflat = tuple(w[None, :] if w.ndim == 1 else w for w in jflat)
    flat = fm.flatten_params(interop.mlp_state_from_jax(params["params"]),
                             True, DEPTH)
    rs = np.random.RandomState(4)
    n = 300  # not a multiple of the JAX tile
    pts = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    views = rs.randn(n, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    g = rs.randn(n, 4).astype(np.float32)
    args = (DEPTH, SKIPS, MR, MV, 128, True)
    want = {"fwd": {dt: np.asarray(jv2._fwd_pallas(
        jflat, jnp.asarray(pts), jnp.asarray(views), *args, dt))
        for dt in (jnp.float32, jnp.bfloat16)}}
    for name, op in (("train", jv2.fused_mlp_v2_train),
                     ("hybrid", jv2.hybrid_mlp_v2_train)):
        _, vjp = jax.vjp(lambda w, op=op: op(
            w, jnp.asarray(pts), jnp.asarray(views), *args, jnp.float32),
            jflat)
        want[name] = [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]
    return flat, [torch.from_numpy(x) for x in (pts, views, g)], want


def test_plain_row_fwd_matches_jax_row_kernel(nerf_case):
    flat, (pts, views, _), want = nerf_case
    got = v2.fwd(flat, pts, views, DEPTH, SKIPS, MR, MV, "float32")
    assert got.shape == (pts.shape[0], 4)
    np.testing.assert_allclose(got.numpy(), want["fwd"][jnp.float32],
                               **FP32_TOL)
    got16 = v2.fwd(flat, pts, views, DEPTH, SKIPS, MR, MV, "bfloat16")
    b = want["fwd"][jnp.bfloat16]
    assert np.abs(got16.numpy() - b).max() / np.abs(b).mean() < BF16_TOL
    # The row-major kernel runs #1's walk: the packed walk over the
    # transposed streams is its reference at bf16 too.
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "bfloat16")
    walk = v2.packed_reference_T(packed, pts.T, views.T).T
    assert np.abs(walk.numpy() - b).max() / np.abs(b).mean() < BF16_TOL
    # fused_mlp_v2: the same forward from a NeRFMLP state dict.
    sd = {f"{k}": w for k, w in zip(
        [f"{n}.{p}" for n in [f"pts_linears.{i}" for i in range(DEPTH)]
         + ["alpha_linear", "feature_linear", "views_linears.0",
            "rgb_linear"] for p in ("weight", "bias")], flat)}
    got2 = v2.fused_mlp_v2(sd, pts, views, net_depth=DEPTH, skips=SKIPS,
                           multires=MR, multires_views=MV)
    assert torch.equal(got2, got)


def test_plain_row_bwd_matches_jax_row_kernel(nerf_case):
    flat, (pts, views, g), want = nerf_case
    got = v2.bwd(flat, pts, views, g, DEPTH, SKIPS, MR, MV, "float32")
    assert [x.shape for x in got] == [w.shape for w in flat]
    _assert_grads(got, want["train"], **DW_TOL)
    before = (v2.row_launches, v2.row_bwd_launches)
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "bfloat16")
    walk = v2.packed_bwd_reference_T(packed, pts.T, views.T, g.T)
    want16 = [np.asarray(x) for x in jax.vjp(
        lambda w: jv2.fused_mlp_v2_train(
            w, jnp.asarray(pts.numpy()), jnp.asarray(views.numpy()), DEPTH,
            SKIPS, MR, MV, 128, True, jnp.bfloat16),
        tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()[None])
              for w in flat))[1](jnp.asarray(g.numpy()))[0]]
    for a, b in zip(_jax_layout(walk), want16):
        b = np.asarray(b).reshape(a.shape)
        assert np.abs(a - b).max() <= BF16_TOL * np.abs(b).mean() + 1e-6
    assert (v2.row_launches, v2.row_bwd_launches) == before  # CPU: plain


@pytest.mark.parametrize("hybrid", [False, True], ids=["train", "hybrid"])
def test_row_ops_autograd_match_jax(nerf_case, hybrid):
    """fused_mlp_v2_train (forward #10) and hybrid_mlp_v2_train (the plain
    forward): the raw output and, by autograd through #11, the weight
    grads of the JAX ops; the points get no grad."""
    flat, (pts, views, g), want = nerf_case
    leaves = [w.clone().requires_grad_() for w in flat]
    op = v2.hybrid_mlp_v2_train if hybrid else v2.fused_mlp_v2_train
    p = pts.clone().requires_grad_()
    raw = op(leaves, p, views, DEPTH, SKIPS, MR, MV, "float32")
    np.testing.assert_allclose(raw.detach().numpy(),
                               want["fwd"][jnp.float32], **FP32_TOL)
    (raw * g).sum().backward()
    _assert_grads([w.grad for w in leaves],
                  want["hybrid" if hybrid else "train"], **DW_TOL)
    assert p.grad is None


# --------------------------- kernels #15, #16 -----------------------------


@pytest.fixture(scope="module")
def mip_case(request):
    return once_per_run(request, _mip_case)


def _mip_case():
    depth, width, nf = 8, 64, 16
    m = JaxMipMLP(net_depth=depth, net_width=width, max_deg_point=nf,
                  disable_normals=True)
    z = jnp.zeros((2, 3))
    params = jax.tree_util.tree_map(np.asarray, m.init(
        jax.random.PRNGKey(0), None, (z, z), z))
    jflat = tuple(jnp.asarray(w)
                  for w in jfmip.flatten_mip_params(params, depth))
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = fmip.flatten_mip_params(
        {k[len("mlp."):]: v for k, v in sd.items()}, depth)
    rs = np.random.RandomState(2)
    n = 160
    means = (rs.rand(n, 3) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(n, 3) * 1e-3).astype(np.float32)
    views = rs.randn(n, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    g = rs.randn(n, 4).astype(np.float32)
    ins = [jnp.asarray(x) for x in (means, covs, views)]
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        raw, vjp = jax.vjp(lambda w, dt=dt: jfmip.fused_mip_mlp_train(
            w, *ins, depth, 4, nf, 4, 128, True, dt), jflat)
        want[dt] = (np.asarray(raw),
                    [np.asarray(x) for x in vjp(jnp.asarray(g))[0]])
    return (depth, nf), flat, [torch.from_numpy(x) for x in
                               (means, covs, views, g)], want


def test_plain_mip_row_kernels_match_jax(mip_case):
    (depth, nf), flat, (m, c, v, g), want = mip_case
    got = fmip.fwd(flat, m, c, v, depth, nf, "float32")
    assert got.shape == (m.shape[0], 4)
    np.testing.assert_allclose(got.numpy(), want[jnp.float32][0],
                               **MIP_FWD_TOL)
    got16 = fmip.fwd(flat, m, c, v, depth, nf, "bfloat16").numpy()
    b = want[jnp.bfloat16][0]
    assert np.abs(got16 - b).max() / np.abs(b).mean() < BF16_TOL
    grads = fmip.bwd(flat, m, c, v, g, depth, nf, "float32")
    assert [x.shape for x in grads] == [w.shape for w in flat]
    for i, (a, b) in enumerate(zip(_jax_layout(grads), want[jnp.float32][1])):
        b = np.asarray(b, np.float64).reshape(a.shape)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < MIP_DW_REL, f"weight {i}: rel L2 {rel:.3e}"


def test_fused_mip_mlp_train_matches_jax(mip_case):
    """The op: forward #15, weight grads from #16 by autograd, zero grads
    for the means, covs and views (the JAX VJP)."""
    (depth, nf), flat, (m, c, v, g), want = mip_case
    leaves = [w.clone().requires_grad_() for w in flat]
    ins = [x.clone().requires_grad_() for x in (m, c, v)]
    raw = fmip.fused_mip_mlp_train(leaves, *ins, depth, nf, "float32")
    np.testing.assert_allclose(raw.detach().numpy(), want[jnp.float32][0],
                               **MIP_FWD_TOL)
    (raw * g).sum().backward()
    for i, (a, b) in enumerate(zip(_jax_layout([w.grad for w in leaves]),
                                   want[jnp.float32][1])):
        b = np.asarray(b, np.float64).reshape(a.shape)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < MIP_DW_REL, f"weight {i}: rel L2 {rel:.3e}"
    for x in ins:
        assert torch.equal(x.grad, torch.zeros_like(x))


# ----------------------- the v2row and v2h renders ------------------------


@pytest.fixture(scope="module")
def render_case(request):
    """Seeded JAX VanillaNeRF params, the port model carrying the same
    weights, and rays through the [near, far] band (the render tests'
    setup: depth 8, width 32, 8 + 8 samples, multires 4 / 2)."""
    return once_per_run(request, _render_case)


def _render_case():
    rs = np.random.RandomState(3)
    n = 40
    d = rs.randn(n, 3).astype(np.float32)
    o = (-2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
         + 0.3 * rs.randn(n, 3)).astype(np.float32)
    ones = np.ones((n, 1), np.float32)
    fields = dict(origins=o, directions=d,
                  viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=ones * 1e-3, lossmult=ones, near=ones * 0.5,
                  far=ones * 4.5)
    jrays = JaxRays(**{k: jnp.asarray(x) for k, x in fields.items()})
    prays = Rays(**{k: torch.from_numpy(x) for k, x in fields.items()})
    kw = dict(num_samples=8, num_importance=8, multires=4, multires_views=2,
              net_depth=8, white_bkgd=True)
    jmodel = JaxVanillaNeRF(num_samples=8, num_importance=8, multires=4,
                            multires_views=2, net_depth=8, net_width=32,
                            white_bkgd=True)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), None, jrays))
    model = VanillaNeRF(num_samples=8, num_importance=8, multires=4,
                        multires_views=2, net_depth=8, net_width=32,
                        white_bkgd=True)
    model.load_state_dict(interop.params_from_jax(params))
    weights = {lvl: fm.flatten_params(getattr(model, lvl), True, 8)
               for lvl in ("coarse", "fine")}
    return params, jrays, weights, prays, kw


@pytest.mark.parametrize("kernel", ["v2row", "v2h", "v1", "hybrid"])
def test_row_and_hybrid_renders_match_jax(render_case, kernel):
    params, jrays, weights, prays, kw = render_case
    want = jfr.fused_render_rays(params, jrays, tile=32, interpret=True,
                                 kernel=kernel, pdf_kernel=False, **kw)
    with torch.no_grad():
        got = fused_render.fused_render_rays(weights, prays, kernel=kernel,
                                             **kw)
    for k in ("rgb", "depth", "acc", "rgb0", "depth0", "disp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
