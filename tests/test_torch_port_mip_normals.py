"""The mip normals and the mip pdf-kernel routes vs the JAX package.

The port's `MipMLP(disable_normals=False)` (normals by autograd) is held
against the flax one; the plain version of kernel 6n
(`ops/fused_mip.py::fused_mip_mlp_normals_T`: the raw heads and
d(raw density)/d(means) [7, N]) against the JAX
`fused_mip_mlp_normals_T` in interpret mode; `fused_mip_forward` and the
mip `build_render_fn` with normals (the fused route through 6n and,
with `use_pdf_kernel`, kernel #9) against the JAX ones, the normals map
included; and the one-pass mip step with `use_pdf_kernel` against the
JAX one at randomized=False. fp32; depth 2 and 8 at width 32-64, 4 IPE
frequencies (16 for the kernel rows).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import MipBatcher as JaxMipBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.ops.fused_train import \
    fused_mip_forward as jax_fused_mip_forward
from consistentnerf_tpu.train import evaluation as jeval
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import render as jrender
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import images, synthetic
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.models.mlp import MipMLP
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import pdf_merge
from consistentnerf_tpu_torch.ops.fused_train import fused_mip_forward
from consistentnerf_tpu_torch.train import evaluation, loop, vis
from consistentnerf_tpu_torch.train import render as render_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, white_bkgd=True, disable_normals=False,
           render_chunk_size=100)
TOL = dict(atol=2e-4, rtol=2e-4)  # the mip model tests' bound
NORMALS_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS_REL = 1e-5  # max |port - JAX| / max |JAX| per row, fp32
# The same at bf16: both round at the same points, so only the fp32 sums'
# order differs (1e-7 here); a wrong rounding point moves a row by ~1e-2.
BF16_ROWS_REL = 1e-4
KEYS = ("rgb", "distance_mean", "acc", "distance_median")


def _samples(n, seed):
    rs = np.random.RandomState(seed)
    means = (rs.rand(n, 3) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(n, 3) * 1e-3).astype(np.float32)
    views = rs.randn(n, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    return means, covs, views


def _jax_mlp(depth, width, nf, seed=0):
    m = JaxMipMLP(net_depth=depth, net_width=width, max_deg_point=nf,
                  disable_normals=False)
    z = jnp.zeros((2, 3))
    params = jax.tree_util.tree_map(np.asarray, m.init(
        jax.random.PRNGKey(seed), None, (z, z), z))
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    return m, params, {k[len("mlp."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("depth", [2, 8])
def test_mip_mlp_normals_match_flax(depth):
    m, params, sd = _jax_mlp(depth, 32, 4)
    means, covs, views = _samples(60, 1)
    jrgb, jdens, jnorm = m.apply(params, None, (means, covs), views)
    mlp = MipMLP(net_depth=depth, net_width=32, max_deg_point=4,
                 disable_normals=False)
    mlp.load_state_dict(sd)
    with torch.no_grad():
        rgb, dens, normals = mlp(*[torch.tensor(x) for x in
                                   (means, covs, views)])
    assert not normals.requires_grad and not dens.requires_grad
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOL)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), **TOL)
    np.testing.assert_allclose(normals.numpy(), np.asarray(jnorm),
                               **NORMALS_TOL)
    np.testing.assert_allclose(np.linalg.norm(normals.numpy(), axis=-1),
                               1.0, atol=1e-5)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        mlp(*[torch.tensor(x) for x in (means, covs, views)])
    off = MipMLP(net_depth=depth, net_width=32, max_deg_point=4)
    off.load_state_dict(sd)
    rgb0, dens0, none = off(*[torch.tensor(x) for x in
                              (means, covs, views)])
    assert none is None
    torch.testing.assert_close(rgb0.detach(), rgb)
    torch.testing.assert_close(dens0.detach(), dens)


@pytest.mark.parametrize("depth,nf", [(2, 4), (8, 16)])
def test_plain_normals_rows_match_jax_kernel(depth, nf):
    """Plain 6n against the JAX kernel (interpret) in fp32 and bf16: the
    raw heads and rows 4-6, d(raw density)/d(means), each row within
    ROWS_REL (BF16_ROWS_REL) of its largest value; the raw heads equal
    the plain #6's."""
    m, params, sd = _jax_mlp(depth, 64, nf)
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(
        {"params": params["params"]}, depth)]
    flat = [sd[f"dense.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}"]
            for i in range(2 * (depth + 4))]
    means, covs, views = (x.T.copy() for x in _samples(200, 2))
    args = [torch.tensor(x) for x in (means, covs, views)]
    for cd, tol in (("float32", ROWS_REL), ("bfloat16", BF16_ROWS_REL)):
        want = np.asarray(jfmip.fused_mip_mlp_normals_T(
            jflat, jnp.asarray(means), jnp.asarray(covs),
            jnp.asarray(views), net_depth=depth, num_freqs=nf, tile=128,
            interpret=True, compute_dtype=jnp.dtype(cd).type))
        with torch.no_grad():
            got = fmip.fused_mip_mlp_normals_T(flat, *args, depth, nf, cd)
            packed = fmip.fused_mip_mlp_normals_T(
                fmip.pack(flat, depth, nf, cd), *args, depth, nf, cd)
            fwd = fmip.plain_fwd_T(flat, *args, depth, nf, cd)
        assert got.shape == (7, 200)
        rel = (np.abs(got.numpy() - want).max(1)
               / np.abs(want).max(1).clip(1e-30))
        assert rel.max() < tol, (cd, rel)
        torch.testing.assert_close(packed, got, rtol=0, atol=0)
        torch.testing.assert_close(got[:4], fwd, rtol=0, atol=0)


@pytest.fixture(scope="module")
def mip_setup(request):
    return once_per_run(request, _mip_setup)


def _mip_setup():
    rs = np.random.RandomState(0)
    n = 40
    d = rs.randn(n, 3).astype(np.float32)
    o = (-4 * d / np.linalg.norm(d, axis=1, keepdims=True)
         + 0.2 * rs.randn(n, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    ones = np.ones((n, 1), np.float32)
    fields = dict(origins=o, directions=d, viewdirs=v,
                  radii=(0.004 * ones).astype(np.float32), lossmult=ones,
                  near=2 * ones, far=6 * ones)
    jrays = JaxRays(**{k: jnp.asarray(x) for k, x in fields.items()})
    prays = Rays(**{k: torch.tensor(x) for k, x in fields.items()})
    jcfg = JaxConfig(use_tensorboard=False, **CFG)
    jmodel = jax_make_model(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), None, jrays, 0.01,
                                False))
    cfg = configs.Config(**CFG)
    model = make_model(cfg, "cpu")
    model.load_state_dict(interop.mip_params_from_jax(params))
    return jcfg, jmodel, params, jrays, cfg, model, prays


@pytest.mark.parametrize("pdf_kernel", [False, True])
def test_fused_mip_forward_with_normals_matches_jax(mip_setup, pdf_kernel):
    jcfg, jmodel, params, jrays, cfg, model, prays = mip_setup
    jcfg = jcfg.replace(use_pdf_kernel=pdf_kernel)
    cfg = cfg.replace(use_pdf_kernel=pdf_kernel)
    want = jax_fused_mip_forward(params, None, jrays, jcfg, 0.01, True,
                                 tile=64, interpret=True)
    before = pdf_merge.mip_launches
    with torch.no_grad():
        got = fused_mip_forward(
            fmip.flatten_mip_params(model.mlp, cfg.netdepth), None, prays,
            cfg, 0.01, compute_extras=True)
    assert pdf_merge.mip_launches == before  # the CPU runs the plain one
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in KEYS:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       err_msg=f"level {lvl} {k}", **TOL)
        np.testing.assert_allclose(g["normals"].numpy(),
                                   np.asarray(w["normals"]),
                                   err_msg=f"level {lvl}", **NORMALS_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_mip_render_with_normals_matches_jax(mip_setup, fused):
    """build_render_fn with disable_normals=false, the plain and the fused
    (6n, #9 with use_pdf_kernel) chunk renderers, against the JAX render:
    the normals map included; visualize_normals as the JAX one."""
    jcfg, jmodel, params, _, cfg, model, _ = mip_setup
    sw = dict(use_fused_render=fused, use_pdf_kernel=fused)
    scene = jsynth.make_scene(n_views=1, H=12, W=12).to_scene_data()
    jr = jrender.build_render_fn(jmodel, jcfg.replace(**sw), params)
    render = render_lib.build_render_fn(model.eval(), cfg.replace(**sw))
    want = jr(jeval.camera_rays_for_view(scene, scene.poses[0]))
    got = render(evaluation.camera_rays_for_view(scene, scene.poses[0],
                                                 device="cpu"))
    assert set(got) == {"rgb", "depth", "disp", "acc", "distance_median",
                        "normals"}
    assert got["normals"].shape == (12, 12, 3)
    for k in got:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), err_msg=k,
            **(NORMALS_TOL if k == "normals" else TOL))
    from consistentnerf_tpu.train import vis as jvis

    np.testing.assert_allclose(
        vis.visualize_normals(got["normals"].numpy(), got["acc"].numpy()),
        np.asarray(jvis.visualize_normals(np.asarray(want["normals"]),
                                          np.asarray(want["acc"]))),
        atol=1e-5)


def test_evaluate_writes_the_jax_pngs_with_normals(mip_setup, tmp_path):
    """evaluate() of the mip model with normals writes the PNGs the JAX
    package's evaluate() writes: color, depth (matplotlib's turbo), acc
    and normals decode to the same bytes."""
    jcfg, jmodel, params, _, cfg, model, _ = mip_setup
    kw = dict(views=np.array([0, 1]), step=1)
    jeval.evaluate(jmodel, jcfg.replace(eval_disable_lpips=True), params,
                   jsynth.make_scene(n_views=2, H=12, W=12).to_scene_data(),
                   out_dir=str(tmp_path / "jax"), **kw)
    evaluation.evaluate(
        model.eval(), cfg.replace(eval_disable_lpips=True),
        synthetic.make_scene(n_views=2, H=12, W=12).to_scene_data(),
        out_dir=str(tmp_path / "port"), **kw)
    names = sorted(f for f in os.listdir(tmp_path / "jax")
                   if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(tmp_path / "port")
                           if f.endswith(".png"))
    assert [n[:-8] for n in names] == [
        k for k in ("acc", "color", "depth", "normals") for _ in range(2)]
    for name in names:
        np.testing.assert_array_equal(
            images.read_png(str(tmp_path / "port" / name)),
            images.read_png(str(tmp_path / "jax" / name)), err_msg=name)


def _keep_grads():
    """An optax transformation that updates nothing and keeps the grads
    in its state."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        del state, params
        return jax.tree_util.tree_map(jnp.zeros_like, updates), \
            {"g": updates}

    return optax.GradientTransformation(init, update)


def test_onepass_mip_step_with_pdf_kernel_matches_jax(monkeypatch):
    """The one-pass mip step with use_pdf_kernel (kernel #5, and #9 on the
    data rays' and the patch rays' level 1) against the JAX one, one step
    at randomized=False: loss within 1e-5, grads within 1e-4 relative."""
    kw = dict(backbone="mipnerf", netdepth=2, netwidth=32,
              mip_num_samples=8, max_deg_point=4, disable_normals=True,
              N_rand=64, white_bkgd=True, randomized=False,
              use_fused_train=True, use_onepass_train=True,
              compute_depth_metrics=True, compute_mono_depth_metrics=True,
              use_hardmask=True, dataset_type="blender",
              use_pdf_kernel=True)
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **kw)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    jmodel = jax_make_model(jcfg)
    batch = JaxMipBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, jmodel, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    params = jax.device_get(state.params)
    s, want = jop.build_onepass_mip_train_step(
        jcfg, tx=tx, donate=False, tile=256)(state, batch,
                                             jax.random.PRNGKey(0))
    want_grads = interop.mip_params_from_jax(
        jax.device_get(s.opt_state["g"]))

    cfg = configs.Config(**kw)
    pstate = loop.init_state(cfg, "cpu")
    pstate.model.load_state_dict(interop.mip_params_from_jax(params))
    opt, grads = pstate.optimizer, {}
    update = opt.step
    names = [n for n, _ in pstate.model.named_parameters()]

    def keep(count):
        for name, p in zip(names, opt.params):
            grads[name] = p.grad.detach().clone()
        update(count)

    opt.step = keep
    rays = Rays(**{f: torch.tensor(np.asarray(getattr(batch["rays"], f)))
                   for f in ("origins", "directions", "viewdirs", "radii",
                             "lossmult", "near", "far")})
    pbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()
              if k != "rays"}
    pbatch["rays"] = rays
    calls = []
    real = pdf_merge.mip_resample_t_vals

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(pdf_merge, "mip_resample_t_vals", spy)
    _, stats = op.build_onepass_mip_train_step(cfg)(pstate, pbatch)
    assert sorted(calls) == [64, 4 * 16 * 16]
    for k in ("loss", "losses", "depth_mses", "mono_depth_mses", "psnr"):
        np.testing.assert_allclose(np.asarray(stats[k]),
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k, g in grads.items():
        w = want_grads["mlp." + k if not k.startswith("mlp.") else k]
        rel = (torch.linalg.norm(g - w.reshape(g.shape))
               / torch.linalg.norm(w)).item()
        assert rel < 1e-4, f"{k}: grad rel L2 {rel:.3e}"
