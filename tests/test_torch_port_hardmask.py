"""The port's reprojection hard masks vs the JAX package.

`load_scene` with `hardmask=true` (the flagship ConsistentNeRF setting)
attaches the masks of `consistency/reproject.py::compute_hard_masks`,
computed here on CPU tensors, under the JAX package's cache key; they are
held against the JAX `load_scene` on the synthetic sphere and cluster
layouts. The rule: identical, except pixels that
`reproject.boundary_pixels` flags (a projected coordinate within 1e-4 px
of a rounding boundary, or a |depth diff| within 1e-5 relative of its
chunk's threshold), which may differ and are bounded at 0.01% of the
train pixels. The pieces (projection, the closed-form threshold, one
target/reference pair) are held against the JAX functions, and the
softmask and edge-mask configs, not ported yet, raise instead of training
on other masks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.consistency import reproject as jrep
from consistentnerf_tpu.data import loaders as jloaders
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.consistency import reproject
from consistentnerf_tpu_torch.data import loaders

# (layout, H = W, views): 48 puts XLA's reciprocal rounding on the border
# (reproject._recip), 64 is the Config default.
SCENES = [("sphere", 48, 6), ("sphere", 64, 8), ("cluster", 48, 6),
          ("cluster", 64, 8)]
MAX_BOUNDARY_SHARE = 1e-4  # of the train pixels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(layout, hw, views):
    return dict(dataset_type="synthetic", hardmask=True,
                synthetic_layout=layout, synthetic_hw=hw,
                synthetic_views=views)


@pytest.mark.parametrize("layout,hw,views", SCENES,
                         ids=[f"{s[0]}-{s[1]}" for s in SCENES])
def test_load_scene_hard_masks_match_jax(tmp_path, layout, hw, views):
    kw = _kw(layout, hw, views)
    want = jloaders.load_scene(JaxConfig(basedir=str(tmp_path),
                                         expname="jax", **kw))
    got = loaders.load_scene(configs.Config(basedir=str(tmp_path),
                                            expname="port", **kw),
                             device="cpu")
    assert got.masks.dtype == np.float32
    assert got.masks.shape == want.masks.shape
    np.testing.assert_array_equal(got.i_train, want.i_train)
    # Non-train views carry zeros, as in the JAX package.
    assert not got.masks[got.i_test].any()
    diff = got.masks != want.masks
    near = reproject.boundary_pixels(
        got.poses, got.depths, got.K, got.i_train, got.H, got.W,
        device="cpu")
    n_train = len(got.i_train) * got.H * got.W
    assert not (diff & ~near).any(), "masks differ off the boundary rule"
    assert diff.sum() <= MAX_BOUNDARY_SHARE * n_train
    assert 0.1 < got.masks[got.i_train].mean() < 0.6
    # The same cache file name as the JAX package's.
    cache = [sorted(os.listdir(tmp_path / e / "mask_cache"))
             for e in ("jax", "port")]
    assert cache[0] == cache[1] and len(cache[0]) == 1
    assert cache[0][0].startswith(f"hardmask_3view_0.1_")


def test_cached_masks_are_read_back_and_keyed_on_the_split(tmp_path):
    cfg = configs.Config(basedir=str(tmp_path), expname="e",
                         **_kw("sphere", 24, 4))
    first = loaders.load_scene(cfg, device="cpu")
    cache_dir = tmp_path / "e" / "mask_cache"
    (name,) = os.listdir(cache_dir)
    stamp = np.zeros_like(first.masks, dtype=bool)
    stamp[first.i_train, 0, 0] = True
    np.save(cache_dir / name, stamp)
    again = loaders.load_scene(cfg, device="cpu")
    np.testing.assert_array_equal(again.masks, stamp.astype(np.float32))
    other = loaders.load_scene(cfg.replace(synthetic_n_test=1),
                               device="cpu")
    assert len(os.listdir(cache_dir)) == 2
    assert other.masks.shape == first.masks.shape


def test_reprojection_pieces_match_jax():
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    c2w[:3, 3] = [0.3, -0.2, 4.0]
    K = np.array([[40.0, 0, 23.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    w2c = np.array(jnp.linalg.inv(jnp.asarray(c2w)))
    want = jax.jit(jrep.world_to_ref_pixels, static_argnums=(3, 4))(
        jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(K), 48, 48)
    got = reproject.world_to_ref_pixels(
        torch.from_numpy(pts), torch.from_numpy(w2c), torch.from_numpy(K),
        48, 48)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The closed form at and around powers of two, and with no valid pixel.
    diffs = np.array([0.0, 0.05, 0.1, 0.0999999, 0.1000001, 0.2, 0.3999,
                      0.4, 0.8000001, 3.2, 1e-30, np.inf], np.float32)
    want = jax.jit(jrep._effective_threshold, static_argnums=1)(
        jnp.asarray(diffs), 0.1)
    got = reproject._effective_threshold(torch.from_numpy(diffs), 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    depth = rs.uniform(2.0, 6.0, (48, 48)).astype(np.float32)
    for thr in (0.1, 0.05):
        want = jax.jit(jrep.consistency_mask_pair, static_argnums=(4, 5))(
            jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(depth),
            jnp.asarray(K), thr, 128)
        got = reproject.consistency_mask_pair(
            torch.from_numpy(pts), torch.from_numpy(w2c),
            torch.from_numpy(depth), torch.from_numpy(K), thr, 128)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("flag", ["softmask", "use_canny_edge_detection",
                                  "use_sobel_edge_detection"])
def test_unported_mask_variants_raise(tmp_path, flag):
    cfg = configs.Config(basedir=str(tmp_path), **_kw("sphere", 16, 4))
    with pytest.raises(NotImplementedError, match="Queue 1: consistency"):
        loaders.load_scene(cfg.replace(**{flag: True}), device="cpu")
