"""The port's MVS depth prior (`models/mvs.py`, `train/mvs.py`) against the
JAX package, on the synthetic sphere scene of `tests/test_mvs.py` (6 views,
48x48, 16 depth planes, base width 4) and at 47x63, where the feature map
(12x16) is not a quarter of the image and flax's stride-2 `SAME` padding
is asymmetric (48 -> 24 -> 12 in the feature net, 16 -> 8 -> 4 planes in
the cost net).

The JAX params come from a numpy seed in the tree `MVSDepthNet.init` makes
(its shapes by `jax.eval_shape`) and reach the port through
`interop.mvs_params_from_jax`. Tolerances, fp32 on the CPU:
* geometry: depths 1e-5 absolute, pixel coordinates (up to ~60) 1e-4,
  warped values 1e-4 (the coordinates agree to ~1e-5 px, and the sphere's
  limb changes an image by up to ~1 a pixel);
* the network's outputs: depth and depth_lo 2e-5 (values up to 6), conf
  and prob 1e-6;
* losses 1e-5 relative; gradients 1e-4 of each leaf's largest entry,
  floored at 1e-6 of the tree's largest gradient: two leaves have a zero
  gradient by symmetry (the cost net's last bias, which the softmax over
  the planes ignores, and the feature net's last bias, which the variance
  cancels but at the frustum's edges), so their entries are float noise;
* params after 3 Adam steps 1e-4 of each leaf's largest entry, but for
  entries whose first gradient is float noise (below 1e-5 of the tree's
  largest), where Adam's g / |g| steps either way (counted, at most 0.1%
  of the params);
* thresholds that fp32 noise can flip (the confidence window |offs| <=
  1.5, conf >= mvs_conf_thresh) are compared away from their edges, and
  the flips at the edges are counted and bounded.
Every JAX function runs jitted, compiled once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynthetic
from consistentnerf_tpu.models import mvs as jmvs
from consistentnerf_tpu.train import mvs as jtrain
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.consistency import reproject
from consistentnerf_tpu_torch.core import rays as rays_core
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.models import mvs
from consistentnerf_tpu_torch.train import mvs as mvs_train
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

GEOM_TOL = 1e-5
PIX_TOL = 1e-4
WARP_TOL = 1e-4
DEPTH_TOL = 2e-5
PROB_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 1e-4
ADAM_NOISE_SHARE = 1e-3
EDGE = 1e-4  # a threshold's edge: |value - threshold| below this
MAX_FLIP_SHARE = 1e-2  # of the pixels, at the edges only
SIZES = [(48, 48), (47, 63)]
MVS = dict(mvs_num_depths=16, mvs_base_ch=4, mvs_n_src=2, mvs_lr=3e-3)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scenes(h, w):
    js = jsynthetic.make_scene(n_views=6, H=h, W=w).to_scene_data()
    ps = synthetic.make_scene(n_views=6, H=h, W=w).to_scene_data()
    assert np.array_equal(js.images, ps.images)
    return js, ps


def _triple(scene, ref=None):
    ref = int(scene.i_train[0]) if ref is None else ref
    srcs = mvs.select_source_views(scene.poses, scene.i_train, ref, 2)
    np.testing.assert_array_equal(
        srcs, jmvs.select_source_views(scene.poses, scene.i_train, ref, 2))
    return (scene.images[ref].astype(np.float32),
            scene.images[srcs].astype(np.float32),
            scene.poses[ref][:3, :4].astype(np.float32),
            scene.poses[srcs][:, :3, :4].astype(np.float32),
            scene.K.astype(np.float32))


def _param_tree(net, args, near, far, seed=0):
    """numpy params in the tree net.init makes: lecun-scaled kernels,
    small biases, the cost net's last kernel scaled up so that the
    softmax over the planes is peaked (the confidence window then
    matters)."""
    shapes = jax.eval_shape(
        lambda k: net.init(k, *map(jnp.asarray, args), near, far),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if len(s.shape) == 1:
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if "cost_reg" in str(path) and "Conv_5" in str(path):
            a = a * 40.0
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def nets(request):
    """Per size: both scenes, the view triple, the JAX net and params,
    and the port net carrying them."""
    return once_per_run(request, _nets)


def _nets():
    out = {}
    for h, w in SIZES:
        js, ps = _scenes(h, w)
        args = _triple(js)
        jnet = jmvs.MVSDepthNet(num_depths=16, base_ch=4)
        tree = _param_tree(jnet, args, float(js.near), float(js.far))
        pnet = mvs.MVSDepthNet(16, 4)
        pnet.load_state_dict(interop.mvs_params_from_jax(tree))
        out[h, w] = dict(js=js, ps=ps, args=args, jnet=jnet, tree=tree,
                         pnet=pnet)
    return out


def _jax_forward(jnet, tree, args, near, far):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jnet.apply, static_argnums=(6, 7))(tree, *map(jnp.asarray, args),
                                           near, far))


# --- geometry --------------------------------------------------------------


def test_scale_k_and_project_to_pixels_match_jax():
    js, _ = _scenes(47, 63)
    K = js.K.astype(np.float32)
    sx, sy = 16 / 63, 12 / 47
    np.testing.assert_allclose(mvs.scale_K(_t(K), sx, sy).numpy(),
                               np.asarray(jmvs.scale_K(jnp.asarray(K), sx,
                                                       sy)), atol=1e-6)
    rng = np.random.RandomState(0)
    pts = (rng.randn(2, 300, 3) * 1.5).astype(np.float32)
    c2w = js.poses[1:3, :3, :4].astype(np.float32)
    got = mvs.project_to_pixels(_t(pts), _t(c2w), _t(K), 47, 63)
    proj = jax.jit(jax.vmap(jmvs.project_to_pixels,
                            in_axes=(0, 0, None, None, None)),
                   static_argnums=(3, 4))
    want = proj(jnp.asarray(pts), jnp.asarray(c2w), jnp.asarray(K), 47, 63)
    for g, w_, tol in zip(got[:3], want[:3], (PIX_TOL, PIX_TOL, GEOM_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=tol,
                                   rtol=1e-6)
    # valid: identical but where x or y sits on a frustum edge.
    x, y = got[0].numpy(), got[1].numpy()
    edge = ((np.abs(x) < EDGE) | (np.abs(x - 62) < EDGE) | (np.abs(y) < EDGE)
            | (np.abs(y - 46) < EDGE))
    diff = got[3].numpy() != np.asarray(want[3])
    assert not (diff & ~edge).any()
    assert 0.1 < got[3].numpy().mean() < 0.9


def test_bilinear_sample_matches_jax_with_its_coordinate_gradient():
    rng = np.random.RandomState(1)
    img = rng.rand(12, 16, 5).astype(np.float32)
    # Inside, beyond each border, and a batch of two images.
    x = rng.uniform(-2, 18, (2, 7, 9)).astype(np.float32)
    y = rng.uniform(-2, 14, (2, 7, 9)).astype(np.float32)
    r = rng.randn(2, 7, 9, 5).astype(np.float32)

    def jloss(xx, yy, im):
        return jnp.sum(jax.vmap(jmvs.bilinear_sample,
                                in_axes=(None, 0, 0))(im, xx, yy) * r)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, (0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(img))
    tx, ty, ti = (_t(a).requires_grad_() for a in (x, y, img))
    got = mvs.bilinear_sample(ti, tx, ty)
    val = (got * _t(r)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval),
                               rtol=LOSS_RTOL)
    for g, w_ in zip((tx.grad, ty.grad, ti.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=GEOM_TOL)
    # The batched form: each image at its own coordinates.
    both = np.stack([img, img[::-1]])
    batched = mvs.bilinear_sample(_t(both), _t(x), _t(y)).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            batched[b], mvs.bilinear_sample(_t(both[b]), _t(x[b]),
                                            _t(y[b])).numpy(), atol=0)


def test_plane_sweep_and_warp_match_jax_with_the_depth_gradient():
    js, _ = _scenes(47, 63)
    ref_img, src_imgs, c2w_ref, c2w_srcs, K = _triple(js)
    d_values = np.linspace(js.near, js.far, 8).astype(np.float32)
    ref = int(js.i_train[0])
    depth = js.depths[ref].astype(np.float32)
    r = np.random.RandomState(2).randn(2, 47, 63, 3).astype(np.float32)

    def jwarp(src, c2w_src):
        return jmvs.plane_sweep_warp(src, jnp.asarray(c2w_ref), c2w_src,
                                     jnp.asarray(K), jnp.asarray(d_values),
                                     47, 63)

    def jphoto(dep):
        warped, valid = jax.vmap(
            lambda s, c: jmvs.warp_src_to_ref(s, dep, jnp.asarray(c2w_ref),
                                              c, jnp.asarray(K)))(
            jnp.asarray(src_imgs), jnp.asarray(c2w_srcs))
        return jnp.sum(warped * r), (warped, valid)

    fn = jax.jit(lambda dep: (jax.vmap(jwarp)(jnp.asarray(src_imgs),
                                              jnp.asarray(c2w_srcs)),
                              jax.value_and_grad(jphoto, has_aux=True)(dep)))
    (jw, jv), ((jval, (jwarped, jvalid)), jgrad) = fn(jnp.asarray(depth))

    pw, pv = mvs.plane_sweep_warp(_t(src_imgs), _t(c2w_ref), _t(c2w_srcs),
                                  _t(K), _t(d_values), 47, 63)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=WARP_TOL)
    td = _t(depth).requires_grad_()
    warped, valid = mvs.warp_src_to_ref(_t(src_imgs), td, _t(c2w_ref),
                                        _t(c2w_srcs), _t(K))
    val = (warped * _t(r)).sum()
    val.backward()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(warped.detach().numpy(), np.asarray(jwarped),
                               atol=WARP_TOL)
    np.testing.assert_allclose(float(val.detach()), float(jval),
                               rtol=LOSS_RTOL)
    # The photometric term's gradient into depth goes through the
    # bilinear weights, and it must survive the port.
    assert np.abs(np.asarray(jgrad)).max() > 1e-2
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad),
                               atol=GRAD_RTOL * np.abs(jgrad).max())


# --- the flax convolutions (trouble spots a, b, d) ------------------------


@pytest.mark.parametrize("n", [4, 5])
def test_same_padding_and_transpose_conv_match_flax(n):
    """A 3x3x3 stride-2 SAME conv (flax pads (0, 1) at an even size) and
    the SAME transpose conv (no kernel flip in flax, output 2n), each
    against flax at an even and an odd size."""
    import flax.linen as nn

    rng = np.random.RandomState(n)
    x = rng.randn(1, n, n + 1, n + 2, 3).astype(np.float32)
    for jmod, pmod in (
            (nn.Conv(4, (3, 3, 3), strides=(2, 2, 2), padding="SAME"),
             mvs.SameConv(3, 4, (3, 3, 3), 2)),
            (nn.ConvTranspose(4, (3, 3, 3), strides=(2, 2, 2),
                              padding="SAME"),
             mvs.SameConvTranspose3d(3, 4, (3, 3, 3)))):
        kind = type(jmod).__name__
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))
        tree = jax.tree_util.tree_map(
            lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
        want = np.asarray(jax.jit(jmod.apply)(tree, jnp.asarray(x)))
        sd = interop.mvs_params_from_jax(
            {"params": {"net": {f"{kind}_0": tree["params"]}}})
        pmod.load_state_dict({k.split(".", 3)[-1]: v for k, v in sd.items()})
        got = pmod(_t(x).permute(0, 4, 1, 2, 3), torch.float32).permute(
            0, 2, 3, 4, 1).detach().numpy()
        assert got.shape == want.shape, kind
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=kind)


def test_resizes_match_jax_image_resize():
    """jax.image.resize "nearest" is torch's "nearest-exact" (half-pixel
    centres) and "bilinear" upsampling is F.interpolate's, at 47x63 <->
    12x16."""
    rng = np.random.RandomState(3)
    big = rng.rand(47, 63).astype(np.float32)
    small = rng.rand(12, 16).astype(np.float32)
    near = jax.jit(lambda a: jax.image.resize(a, (12, 16), "nearest"))
    up = jax.jit(lambda a: jax.image.resize(a, (47, 63), "bilinear"))
    np.testing.assert_array_equal(
        F.interpolate(_t(big)[None, None], size=(12, 16),
                      mode="nearest-exact")[0, 0].numpy(),
        np.asarray(near(jnp.asarray(big))))
    np.testing.assert_allclose(
        F.interpolate(_t(small)[None, None], size=(47, 63), mode="bilinear",
                      align_corners=False, antialias=False)[0, 0].numpy(),
        np.asarray(up(jnp.asarray(small))), atol=1e-6)


def test_init_is_flax_lecun_normal():
    """Kernels: truncated normal within 2 std, variance 1 / fan-in with
    fan-in prod(k) * in (transpose kernels too); biases zero; seeded."""
    a = mvs.MVSDepthNet(32, 8)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b = mvs.MVSDepthNet(32, 8)
    b.reset_parameters(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = (p.shape[0] if ".ups." in name else p.shape[1]) * \
            p[0, 0].numel()
        std = np.sqrt(1.0 / fan_in)
        assert p.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7, name
        if p.numel() >= 2000:
            assert abs(p.std().item() / std - 1) < 0.1, name


# --- the network -----------------------------------------------------------


def _window_flips(prob_a, prob_b, D):
    """Low-resolution pixels whose confidence window differs between two
    prob volumes [D, H, W], and those with a plane offset within EDGE of
    the window's 1.5 edge in either."""
    planes = np.arange(D)[:, None, None]
    win, edge = [], np.zeros(prob_a.shape[1:], bool)
    for p in (prob_a, prob_b):
        idx = np.clip((p * planes).sum(0), 0, D - 1)
        offs = np.abs(planes - idx[None])
        win.append(offs <= 1.5)
        edge |= (np.abs(offs - 1.5) < EDGE).any(0)
    return (win[0] != win[1]).any(0), edge


@pytest.mark.parametrize("size", SIZES, ids=["48x48", "47x63"])
def test_subnets_match_jax(nets, size):
    n = nets[size]
    tree = n["tree"]["params"]
    ref_img, src_imgs = n["args"][:2]
    rng = np.random.RandomState(4)
    h, w = size
    hr, wr = -(-h // 4), -(-w // 4)
    imgs = np.concatenate([ref_img[None], src_imgs])
    vol = rng.randn(16, hr, wr, 16).astype(np.float32)
    depth = rng.uniform(2, 6, (h, w)).astype(np.float32)
    jf = jax.jit(lambda p, x: jax.vmap(
        lambda im: jmvs.FeatureNet2D(4).apply({"params": p}, im))(x))
    jc = jax.jit(lambda p, x: jmvs.CostRegNet3D(4).apply({"params": p}, x))
    jr = jax.jit(lambda p, im, d: jmvs.RefineNet2D(8).apply(
        {"params": p}, im, d))
    pnet = n["pnet"]
    with torch.no_grad():
        np.testing.assert_allclose(
            pnet.feature(_t(imgs)).numpy(),
            np.asarray(jf(tree["feature"], jnp.asarray(imgs))), atol=1e-5)
        np.testing.assert_allclose(
            pnet.cost_reg(_t(vol)).numpy(),
            np.asarray(jc(tree["cost_reg"], jnp.asarray(vol))), atol=1e-4)
        np.testing.assert_allclose(
            pnet.refine(_t(ref_img), _t(depth)).numpy(),
            np.asarray(jr(tree["refine"], jnp.asarray(ref_img),
                          jnp.asarray(depth))), atol=DEPTH_TOL)


@pytest.mark.parametrize("size", SIZES, ids=["48x48", "47x63"])
def test_mvs_net_matches_jax(nets, size):
    n = nets[size]
    js = n["js"]
    near, far = float(js.near), float(js.far)
    want = _jax_forward(n["jnet"], n["tree"], n["args"], near, far)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in n["pnet"](
            *map(_t, n["args"]), near, far).items()}
    h, w = size
    hr, wr = -(-h // 4), -(-w // 4)
    assert got["prob"].shape == (16, hr, wr) and got["conf"].shape == (h, w)
    # A peaked volume: the confidence window decides the conf.
    assert got["prob"].max() > 0.5
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    np.testing.assert_allclose(got["prob"], want["prob"], atol=PROB_TOL)
    np.testing.assert_allclose(got["depth_lo"], want["depth_lo"],
                               atol=DEPTH_TOL)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=DEPTH_TOL)
    flips, edge = _window_flips(got["prob"], want["prob"], 16)
    assert not (flips & ~edge).any()
    assert flips.sum() <= MAX_FLIP_SHARE * flips.size
    # conf away from the flipped low-resolution pixels (a full-res pixel
    # reads its 2x2 low-res neighbours).
    grow = F.max_pool2d(_t(flips)[None, None], 3, 1, 1)
    near_flip = F.interpolate(grow, size=(h, w), mode="nearest")[0, 0] > 0
    ok = ~near_flip.numpy()
    np.testing.assert_allclose(got["conf"][ok], want["conf"][ok],
                               atol=PROB_TOL)


def test_bf16_net_stays_near_fp32(nets):
    """bf16 inputs and kernels, fp32 params and softmax: held by its
    distance from the fp32 port (bf16's 8-bit mantissa through 11
    convolution layers)."""
    n = nets[48, 48]
    js = n["js"]
    near, far = float(js.near), float(js.far)
    bf = mvs.MVSDepthNet(16, 4, "bfloat16")
    bf.load_state_dict(n["pnet"].state_dict())
    with torch.no_grad():
        want = n["pnet"](*map(_t, n["args"]), near, far)
        got = bf(*map(_t, n["args"]), near, far)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert torch.isfinite(v).all(), k
    assert bf.feature.convs[0].weight.dtype == torch.float32
    # depth in [2, 6]: mean |diff| < 2e-2 (~0.5% of the range).
    assert (got["depth"] - want["depth"]).abs().mean() < 2e-2
    assert (got["prob"] - want["prob"]).abs().max() < 0.1
    assert (got["conf"] - want["conf"]).abs().mean() < 2e-2


# --- the objective and the trainer -----------------------------------------


@pytest.mark.parametrize("branch", ["supervised", "photometric"])
def test_mvs_loss_and_grads_match_jax(nets, branch):
    """`_mvs_loss` with its gradients: GT depth + photometric + smoothness
    terms, and photometric + smoothness alone."""
    n = nets[48, 48]
    js = n["js"]
    near, far = float(js.near), float(js.far)
    jcfg = JaxConfig(dataset_type="synthetic", **MVS)
    pcfg = configs.Config(dataset_type="synthetic", **MVS)
    ref = int(js.i_train[0])
    gt = js.depths[ref].astype(np.float32) if branch == "supervised" \
        else None
    args = n["args"]

    def jloss(params):
        out = n["jnet"].apply(params, *map(jnp.asarray, args), near, far)
        return jtrain._mvs_loss(
            jcfg, out, jnp.asarray(args[0]), jnp.asarray(args[1]),
            jnp.asarray(args[2]), jnp.asarray(args[3]), jnp.asarray(args[4]),
            None if gt is None else jnp.asarray(gt), near, far)

    (jval, jstats), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(n["tree"])
    pnet = mvs.MVSDepthNet(16, 4)
    pnet.load_state_dict(n["pnet"].state_dict())
    out = pnet(*map(_t, args), near, far)
    loss, stats = mvs_train._mvs_loss(
        pcfg, out, _t(args[0]), _t(args[1]), _t(args[2]), _t(args[3]),
        _t(args[4]), None if gt is None else _t(gt), near, far)
    loss.backward()
    assert set(stats) == set(jstats)
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               rtol=LOSS_RTOL)
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = interop.mvs_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    gmax = max(v.abs().max().item() for v in want.values())
    for name, p in pnet.named_parameters():
        w_ = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w_,
            atol=GRAD_RTOL * max(np.abs(w_).max(), 1e-2 * gmax),
            err_msg=name)


def test_adam_steps_match_jax(nets, monkeypatch):
    """Three steps of each package's `build_mvs_train_step` (GT
    supervision and smoothness, round-robin views) from the same params:
    losses and the params after the last step. The photometric term is
    off here (one JAX compile less; its loss and grads are held above)."""
    n = nets[48, 48]
    js, ps = n["js"], n["ps"]
    jcfg = JaxConfig(dataset_type="synthetic", mvs_photo_weight=0.0, **MVS)
    pcfg = configs.Config(dataset_type="synthetic", mvs_photo_weight=0.0,
                          **MVS)
    monkeypatch.setattr(jmvs.MVSDepthNet, "init",
                        lambda self, *a, **k: n["tree"])
    jstep, jparams, tx = jtrain.build_mvs_train_step(jcfg, js, use_gt=True)
    jstate = tx.init(jparams)
    pstep, pnet, _ = mvs_train.build_mvs_train_step(pcfg, ps, use_gt=True,
                                                    device="cpu")
    pnet.load_state_dict(n["pnet"].state_dict())
    i_train = np.asarray(js.i_train)
    g0 = None
    for it in range(3):
        ref = int(i_train[it])
        srcs = mvs.select_source_views(js.poses, i_train, ref, 2)
        jparams, jstate, jloss, _ = jstep(jparams, jstate, jnp.int32(ref),
                                          jnp.asarray(srcs))
        ploss, _ = pstep(ref, srcs)
        if g0 is None:
            g0 = {k: p.grad.clone() for k, p in pnet.named_parameters()}
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
    want = interop.mvs_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    noisy, total = 0, 0
    gmax = max(g.abs().max().item() for g in g0.values())
    for name, p in pnet.named_parameters():
        w_ = want[name].numpy()
        off = np.abs(p.detach().numpy() - w_) > ADAM_RTOL * np.abs(w_).max()
        # Adam's first update is lr * g / |g|: where g is float noise, the
        # two packages may step either way.
        noise = np.abs(g0[name].numpy()) < 1e-5 * gmax
        assert not (off & ~noise).any(), name
        noisy += int(off.sum())
        total += off.size
    assert noisy <= ADAM_NOISE_SHARE * total


def test_predict_depth_priors_matches_jax(nets):
    """The priors of every train view from the carried params, at a
    threshold that drops about half the pixels: zero elsewhere, depths
    equal where both keep them, and the kept sets equal but within EDGE
    of the threshold."""
    n = nets[48, 48]
    js, ps = n["js"], n["ps"]
    near, far = float(js.near), float(js.far)
    with torch.no_grad():
        conf = n["pnet"](*map(_t, n["args"]), near, far)["conf"].numpy()
    thresh = float(np.median(conf))
    jcfg = JaxConfig(dataset_type="synthetic", **MVS)
    pcfg = configs.Config(dataset_type="synthetic", **MVS)
    want = jtrain.predict_depth_priors(jcfg, js, n["tree"],
                                       conf_thresh=thresh)
    got = mvs_train.predict_depth_priors(
        pcfg, ps, n["pnet"].state_dict(), conf_thresh=thresh, device="cpu")
    others = [v for v in range(len(js.images)) if v not in js.i_train]
    assert not got[others].any()
    kept = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[kept], want[kept], atol=DEPTH_TOL)
    flips = (got > 0) != (want > 0)
    tr = np.asarray(js.i_train)
    assert 0.2 < (got[tr] > 0).mean() < 0.8
    assert flips.sum() <= MAX_FLIP_SHARE * got[tr].size
    # A flipped pixel's conf sits at the threshold in the port's own run.
    if flips.any():
        ref = int(js.i_train[0])
        assert (np.abs(conf - thresh)[flips[ref]] < EDGE).all()


def test_predict_runs_the_net_on_deterministic_cudnn(monkeypatch):
    """The predictor's forward runs with cuDNN's deterministic algorithms
    and no autotuning, and leaves the flags as it found them: otherwise
    the cost net's transposed convolutions may add in another order on the
    card each launch, and a conf at the threshold turns a pixel's prior on
    in one predict and off in the next."""
    scene = synthetic.make_scene(n_views=6, H=16, W=16).to_scene_data()
    cfg = configs.Config(dataset_type="synthetic", **MVS)
    seen, real = [], mvs.MVSDepthNet.forward

    def spy(self, *a, **k):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return real(self, *a, **k)

    monkeypatch.setattr(mvs.MVSDepthNet, "forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    params = mvs_train.make_net(cfg, "cpu").state_dict()
    mvs_train.predict_depth_priors(cfg, scene, params, device="cpu")
    assert seen and all(f == (True, False) for f in seen), seen
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)


# --- the JAX module's own checks, on the port ------------------------------


def test_prior_depths_never_supervise_as_gt():
    """Ground-truth depth supervises (synthetic depths are GT); a scene
    whose depths are loaded priors (depth_is_gt False) trains
    photometrically, never on the priors it is meant to replace."""
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    cfg = configs.Config(dataset_type="synthetic", **MVS)
    assert scene.depth_is_gt
    for sc, want in ((scene, "GT-supervised"),
                     (dataclasses.replace(scene, depth_is_gt=False),
                      "photometric self-supervised")):
        logs = []
        mvs_train.train_mvs_depth(cfg, sc, num_steps=1, log_fn=logs.append,
                                  device="cpu")
        assert any(want in s for s in logs), logs


def test_scale_k_pixel_center_exact_at_non_multiple_of_4():
    """A point at full-res pixel x lands at (x + 0.5) s - 0.5 in the
    downsampled grid, at a size where cx * s would be off by (1 - s) / 2."""
    H, W = 9, 10
    Hf, Wf = -(-H // 4), -(-W // 4)
    sx, sy = Wf / W, Hf / H
    K = torch.tensor([[12.0, 0, 0.5 * W], [0, 12.0, 0.5 * H], [0, 0, 1]])
    Kf = mvs.scale_K(K, sx, sy)
    rng = np.random.RandomState(0)
    pts = _t(rng.randn(64, 3) * 0.3 + np.array([0, 0, -4.0]))
    c2w = torch.eye(4)[:3, :4]
    x, y, z, _ = mvs.project_to_pixels(pts, c2w, K, H, W)
    xf, yf, zf, _ = mvs.project_to_pixels(pts, c2w, Kf, Hf, Wf)
    np.testing.assert_allclose(xf.numpy(), (x.numpy() + 0.5) * sx - 0.5,
                               atol=1e-5)
    np.testing.assert_allclose(yf.numpy(), (y.numpy() + 0.5) * sy - 0.5,
                               atol=1e-5)
    np.testing.assert_allclose(zf.numpy(), z.numpy(), atol=1e-6)


def test_project_to_pixels_matches_reproject_convention():
    """The continuous projection and the hard masks' rounded one agree on
    the camera convention (the y/z flip)."""
    scene = synthetic.make_scene(n_views=3, H=16, W=16)
    c2w = _t(scene.poses[1][:3, :4])
    w2c = rays_core.world_to_camera(c2w)
    pts = _t(np.random.RandomState(1).randn(128, 3) * 0.5)
    K = _t(scene.K)
    x_c, y_c, z_c, _ = mvs.project_to_pixels(pts, c2w, K, 16, 16)
    x_r, y_r, z_r, _ = reproject.world_to_ref_pixels(pts, w2c, K, 16, 16)
    np.testing.assert_allclose(torch.round(x_c).numpy(), x_r.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(torch.round(y_c).numpy(), y_r.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(z_c.numpy(), z_r.numpy(), rtol=1e-5)


def test_mvs_pixel_dirs_is_core_rays_pixel_dirs():

    assert mvs.pixel_dirs is rays_core.pixel_dirs
