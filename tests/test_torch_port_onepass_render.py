"""The render's one-pass level (kernel #4) and the pdf-kernel routes of the
vanilla render and one-pass step vs the JAX package.

`ops/fused_onepass.py::render_level_T` runs its plain version here (the
plain forward and the kernel's compositing) and is held against the JAX
`render_level_T` in interpret mode: depth 4, width 64, multires 4 / 2,
S = 8 and 16, rows within 1e-5 at fp32. The vanilla render with
`use_onepass_render` and `use_pdf_kernel` (kernels #4 and #8) is held
against the JAX render with the same switches, and the one-pass vanilla
step with `use_pdf_kernel` against the JAX one at perturb 0: loss within
1e-4, each parameter's grad within 1e-4 relative L2. The whole render
and the step run at multires 4 / 2: the fine level's inverse CDF
magnifies the order of a sum (ROADMAP Queue 3 item 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.models.nerf import VanillaNeRF as JaxVanillaNeRF
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.ops import fused_render as jfr
from consistentnerf_tpu.train import evaluation as jeval
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import render as jrender
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import fused_render
from consistentnerf_tpu_torch.train import evaluation, loop
from consistentnerf_tpu_torch.train import render as render_lib
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

DEPTH, WIDTH, MR, MV = 4, 64, 4, 2
ROWS_TOL = dict(atol=1e-5, rtol=1e-5)
RENDER_TOL = dict(atol=2e-4, rtol=2e-4)  # the JAX fused render's own bound
KEYS = ["rgb", "depth", "acc", "rgb0", "depth0"]
STEP_CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
                N_importance=8, multires=4, multires_views=2, N_rand=192,
                n_patches=1, patch_size=8, white_bkgd=True, near=2.0,
                far=6.0, hardmask=True, with_depth_loss=True, perturb=0.0,
                use_fused_train=True, use_onepass_train=True,
                use_pdf_kernel=True)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    o = (-2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
         + 0.3 * rs.randn(n, 3)).astype(np.float32)
    ones = np.ones((n, 1), np.float32)
    return dict(origins=o, directions=d,
                viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                radii=ones * 1e-3, lossmult=ones, near=ones * 0.5,
                far=ones * 4.5)


@pytest.fixture(scope="module")
def models(request):
    """Seeded JAX VanillaNeRF params at depth 4, width 64, and the port's
    model carrying the same weights."""
    return once_per_run(request, _models)


def _models():
    fields = _rays(8, 0)
    jrays = JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()})
    kw = dict(num_samples=8, num_importance=16, multires=MR,
              multires_views=MV, net_depth=DEPTH, net_width=WIDTH,
              white_bkgd=True)
    params = jax.tree_util.tree_map(np.asarray, JaxVanillaNeRF(**kw).init(
        jax.random.PRNGKey(0), None, jrays))
    model = VanillaNeRF(**kw)
    model.load_state_dict(interop.params_from_jax(params))
    return params, model


@pytest.mark.parametrize("seg", [8, 16])
@pytest.mark.parametrize("white", [True, False])
def test_plain_render_level_matches_jax(models, seg, white):
    params, model = models
    n = 37
    f = _rays(n, seg)
    rs = np.random.RandomState(seg + 1)
    z = np.sort(0.5 + 4 * rs.rand(n, seg), -1).astype(np.float32)
    pts = (f["origins"].T[:, :, None] + f["directions"].T[:, :, None]
           * z[None]).reshape(3, n * seg).astype(np.float32)
    views = np.repeat(f["viewdirs"].T, seg, 1).astype(np.float32)
    dn = np.repeat(np.linalg.norm(f["directions"], axis=-1)[None], seg,
                   1).astype(np.float32)
    ws = [jnp.asarray(w) for w in jfm.flatten_params(
        {"params": params["params"]["coarse"]}, True, DEPTH)]
    ws = [w[None, :] if w.ndim == 1 else w for w in ws]
    want = jop.render_level_T(
        ws, jnp.asarray(pts), jnp.asarray(views),
        jnp.asarray(z.reshape(1, -1)), jnp.asarray(dn), seg=seg,
        net_depth=DEPTH, multires=MR, multires_views=MV, white_bkgd=white,
        interpret=True)
    flat = fm.flatten_params(model.coarse, True, DEPTH)
    args = (torch.tensor(pts), torch.tensor(views),
            torch.tensor(z.reshape(1, -1)), torch.tensor(dn))
    skips = op.model_skips(DEPTH)  # a skip after layer 4 feeds nothing
    kw = dict(seg=seg, net_depth=DEPTH, skips=skips, multires=MR,
              multires_views=MV, white_bkgd=white)
    with torch.no_grad():
        got = op.render_level_T(flat, *args, **kw)
        packed = op.render_level_T(
            v2.pack(flat, DEPTH, skips, MR, MV, "float32"), *args, **kw)
    assert got.shape == (6, n * seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROWS_TOL)
    torch.testing.assert_close(packed, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="whole rays"):
        op.render_level_T(flat, *[a[:, :-1] for a in args], **kw)


def _render_setup():
    fields = _rays(40, 3)
    jrays = JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()})
    prays = Rays(**{k: torch.from_numpy(v) for k, v in fields.items()})
    kw = dict(num_samples=8, num_importance=8, multires=MR,
              multires_views=MV, net_depth=8, net_width=32, white_bkgd=True)
    params = jax.tree_util.tree_map(np.asarray, JaxVanillaNeRF(**kw).init(
        jax.random.PRNGKey(0), None, jrays))
    model = VanillaNeRF(**kw)
    model.load_state_dict(interop.params_from_jax(params))
    return params, jrays, model, prays


@pytest.mark.parametrize("onepass,pdf_kernel", [(True, True), (True, False),
                                                (False, True)])
def test_switched_fused_render_matches_jax(onepass, pdf_kernel):
    params, jrays, model, prays = _render_setup()
    want = jfr.fused_render_rays(
        params, jrays, num_samples=8, num_importance=8, multires=MR,
        multires_views=MV, net_depth=8, white_bkgd=True, tile=32,
        interpret=True, kernel="v2", onepass=onepass, pdf_kernel=pdf_kernel)
    weights = {lvl: fm.flatten_params(getattr(model, lvl), True, 8)
               for lvl in ("coarse", "fine")}
    with torch.no_grad():
        got = fused_render.fused_render_rays(
            weights, prays, num_samples=8, num_importance=8, multires=MR,
            multires_views=MV, net_depth=8, white_bkgd=True,
            onepass=onepass, pdf_kernel=pdf_kernel)
    for k in KEYS + ["disp", "disp0", "acc0"]:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **RENDER_TOL)


def test_build_render_fn_with_onepass_render_matches_jax():
    """build_render_fn with use_onepass_render and use_pdf_kernel on a
    view against the JAX render with the same switches."""
    sets = dict(dataset_type="synthetic", netdepth=8, netwidth=32,
                N_samples=8, N_importance=8, multires=MR, multires_views=MV,
                white_bkgd=True, use_fused_render=True,
                use_onepass_render=True, use_pdf_kernel=True,
                render_chunk_size=128)
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=32, **sets)
    cfg = configs.Config(**sets)
    scene = jsynth.make_scene(n_views=1, H=10, W=12).to_scene_data()
    jmodel = jax_make_model(jcfg)
    rays0 = jeval.camera_rays_for_view(scene, scene.poses[0])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(2), None, jax.tree_util.tree_map(
            lambda x: x.reshape(-1, x.shape[-1]), rays0)))
    model = make_model(cfg, "cpu").eval()
    model.load_state_dict(interop.params_from_jax(params))
    jr = jrender.build_render_fn(jmodel, jcfg, params)
    render = render_lib.build_render_fn(model, cfg)
    for pose in scene.poses:
        want = jr(jeval.camera_rays_for_view(scene, pose))
        got = render(evaluation.camera_rays_for_view(scene, pose,
                                                     device="cpu"))
        assert set(got) == {"rgb", "depth", "disp", "acc"}
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **RENDER_TOL)


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


def _grads_at_update(state):
    """{name: grad} that the optimizer's next update reads."""
    opt, grads = state.optimizer, {}
    update = opt.step
    names = [n for n, _ in state.model.named_parameters()]

    def step(count):
        for name, p in zip(names, opt.params):
            grads[name] = (torch.zeros_like(p) if p.grad is None
                           else p.grad.detach().clone())
        update(count)

    opt.step = step
    return grads


def test_onepass_step_with_pdf_kernel_matches_jax(monkeypatch):
    """The one-pass vanilla step with use_pdf_kernel (kernels #3 and #8;
    the patch rays' fine depths also through #8) against the JAX one,
    one step from the same params and batch."""
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **STEP_CFG)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    jmodel = jax_make_model(jcfg)
    batch = JaxBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, jmodel, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    params = jax.device_get(state.params)
    s, want = jop.build_onepass_vanilla_train_step(
        jcfg, tx=tx, donate=False, tile=64)(state, batch,
                                            jax.random.PRNGKey(0))
    want_grads = interop.params_from_jax(jax.device_get(s.opt_state["g"]))

    cfg = configs.Config(**STEP_CFG)
    pstate = loop.init_state(cfg, "cpu")
    pstate.model.load_state_dict(interop.params_from_jax(params))
    grads = _grads_at_update(pstate)
    seen = []
    real = op.pdf_merge.sample_pdf_merged

    def spy(*a):
        seen.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(op.pdf_merge, "sample_pdf_merged", spy)
    pstate, stats = loop.select_train_step(cfg, pstate.model)(
        pstate, to_device(batch, "cpu"))
    p = cfg.n_patches * cfg.patch_size ** 2
    assert sorted(seen) == sorted([(p, 16), (cfg.N_rand, 16)])
    for k in ("loss", "img_loss", "depth_loss", "img_loss0", "depth_loss0",
              "psnr"):
        np.testing.assert_allclose(float(stats[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert grads.keys() <= want_grads.keys()
    for k, g in grads.items():
        w = want_grads[k].reshape(g.shape)
        if not torch.any(w != 0):
            assert not torch.any(g != 0), k
            continue
        rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w)).item()
        assert rel < GRAD_REL, f"{k}: grad rel L2 {rel:.3e}"


def test_make_draws_sorts_the_fine_draws_for_the_kernel():
    """use_pdf_kernel with perturb: the fine draws are ascending order
    statistics of the step's uniforms; without it, plain uniforms."""
    cfg = configs.Config(**{**STEP_CFG, "perturb": 1.0})
    draws = step_lib.make_draws(cfg, 50, torch.Generator().manual_seed(1),
                                "cpu")
    u = draws["u"]
    assert u.shape == (50, cfg.N_importance)
    assert torch.all(u[:, 1:] >= u[:, :-1])
    assert float(u.min()) >= 0 and float(u.max()) <= 1
    plain = step_lib.make_draws(cfg.replace(use_pdf_kernel=False), 50,
                                torch.Generator().manual_seed(1), "cpu")
    assert not torch.all(plain["u"][:, 1:] >= plain["u"][:, :-1])
