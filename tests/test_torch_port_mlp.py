"""The port's NeRF MLP, its fused-forward wrapper and the weight bridge vs
the JAX package. The JAX side runs the Pallas kernel `_fwd_pallas_T` in
interpret mode; the port's CPU path is the kernel's plain version. Depth
8 at width 32 keeps the skip layer; multires 10 / 4 as in production."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli.export_torch_ckpt import export_checkpoint
from consistentnerf_tpu.core import encoding as jenc
from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.models.nerf import VanillaNeRF as JaxVanillaNeRF
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_v2 as jv2
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.core import encoding
from consistentnerf_tpu_torch.models.mlp import NeRFMLP
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from torch_port_shared import _one_torch_thread  # noqa: F401

DEPTH, WIDTH, SKIPS, MR, MV = 8, 32, (4,), 10, 4


@pytest.fixture(scope="module")
def mlp_setup():
    """Seeded JAX NeRFMLP params, their port state_dict, and numpy
    points/view directions (N not a multiple of the JAX tile)."""
    mlp = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH)
    params = mlp.init(jax.random.PRNGKey(0), jnp.zeros((2, 63)),
                      jnp.zeros((2, 27)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(1)
    n = 300
    pts = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    views = rs.randn(n, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    sd = interop.mlp_state_from_jax(params["params"])
    return mlp, params, sd, pts, views


def _jax_fwd_T(params, pts, views, dtype):
    weights = [jnp.asarray(w) for w in jfm.flatten_params(params, True,
                                                          DEPTH)]
    weights = [w[None, :] if w.ndim == 1 else w for w in weights]
    out = jv2._fwd_pallas_T(weights, jnp.asarray(pts.T), jnp.asarray(views.T),
                            DEPTH, SKIPS, MR, MV, 128, True, dtype)
    return np.asarray(out)


def _port_fwd_T(sd, pts, views, dtype):
    flat = fm.flatten_params(sd, True, DEPTH)
    return v2.fwd_T(flat, torch.from_numpy(pts.T.copy()),
                    torch.from_numpy(views.T.copy()), DEPTH, SKIPS, MR, MV,
                    dtype).numpy()


def test_plain_forward_matches_jax_kernel_fp32(mlp_setup):
    _, params, sd, pts, views = mlp_setup
    want = _jax_fwd_T(params, pts, views, jnp.float32)
    got = _port_fwd_T(sd, pts, views, "float32")
    assert got.shape == want.shape == (4, len(pts))
    # The bound the JAX kernel meets against its own oracle; its 2^-14
    # raw-x identity is good to ~1e-8.
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_plain_forward_matches_jax_kernel_bf16(mlp_setup):
    _, params, sd, pts, views = mlp_setup
    want = _jax_fwd_T(params, pts, views, jnp.bfloat16)
    got = _port_fwd_T(sd, pts, views, "bfloat16")
    # bf16 operands, fp32 sums on both sides: only the order of the sums
    # (and so an occasional bf16 rounding flip) differs.
    assert np.abs(got - want).max() / np.abs(want).mean() < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_layout_matches_plain(mlp_setup, dtype):
    """The kernel's buffer walk, run on the CPU, equals the plain version:
    the packing is right before any card sees it."""
    _, _, sd, pts, views = mlp_setup
    flat = fm.flatten_params(sd, True, DEPTH)
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, dtype)
    pts_T, views_T = torch.from_numpy(pts.T.copy()), \
        torch.from_numpy(views.T.copy())
    got = v2.packed_reference_T(packed, pts_T, views_T)
    want = v2.plain_fwd_T(flat, pts_T, views_T, DEPTH, SKIPS, MR, MV, dtype)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert packed.w.dtype == fm.as_dtype(dtype)
    # K padded to 16: PE 63 -> 64, skip 63 + W -> 64 + W, views W + 27 ->
    # W + 32; then alpha [W] and rgb [3, W/2].
    W = WIDTH
    trunk = 64 * W + 4 * W * W + (64 + W) * W + 2 * W * W
    heads = W * W + (W + 32) * W // 2 + W + 3 * W // 2
    assert packed.w.numel() == trunk + heads
    assert packed.b.numel() == 8 * W + W + W // 2 + 1 + 3


def test_wrapper_on_cpu_takes_plain_and_launches_nothing(mlp_setup):
    _, _, sd, pts, views = mlp_setup
    flat = fm.flatten_params(sd, True, DEPTH)
    before = v2.launches
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "bfloat16")
    pts_T = torch.from_numpy(pts.T.copy())
    views_T = torch.from_numpy(views.T.copy())
    got = v2.fwd_T(packed, pts_T, views_T, DEPTH, SKIPS, MR, MV, "bfloat16")
    want = v2.plain_fwd_T(flat, pts_T, views_T, DEPTH, SKIPS, MR, MV,
                          "bfloat16")
    assert torch.equal(got, want) and v2.launches == before
    with pytest.raises(ValueError, match="another config"):
        v2.fwd_T(packed, pts_T, views_T, DEPTH, SKIPS, MR, MV, "float32")


def test_pack_rejects_what_the_kernel_cannot_take(mlp_setup):
    sd = mlp_setup[2]
    flat = fm.flatten_params(sd, True, DEPTH)
    with pytest.raises(ValueError):
        v2.pack(flat, DEPTH, (DEPTH - 1,), MR, MV, "float32")
    with pytest.raises(ValueError):
        v2.pack(flat[:-2], DEPTH, SKIPS, MR, MV, "float32")
    narrow = NeRFMLP(net_depth=DEPTH, net_width=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        v2.pack(fm.flatten_params(narrow), DEPTH, SKIPS, MR, MV, "float32")


def test_nerf_mlp_module_matches_flax(mlp_setup):
    mlp, params, sd, pts, views = mlp_setup
    port = NeRFMLP(net_depth=DEPTH, net_width=WIDTH)
    port.load_state_dict(sd, strict=True)
    pe = encoding.posenc_nerf(torch.from_numpy(pts), MR)
    ve = encoding.posenc_nerf(torch.from_numpy(views), MV)
    with torch.no_grad():
        got = port(pe, ve).numpy()
        # The module and the plain fused version are one function.
        plain = fm.reference_mlp_apply(port, torch.from_numpy(pts),
                                       torch.from_numpy(views)).numpy()
    want = np.asarray(mlp.apply(params, jenc.posenc_nerf(pts, MR),
                                jenc.posenc_nerf(views, MV)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=2e-5)


def _jax_vanilla_params(seed=0):
    from consistentnerf_tpu.core.rays import Rays

    model = JaxVanillaNeRF(num_samples=8, num_importance=8,
                           net_depth=DEPTH, net_width=WIDTH)
    ones = jnp.ones((4, 1))
    d = jnp.ones((4, 3)) / jnp.sqrt(3.0)
    rays = Rays(origins=jnp.zeros((4, 3)), directions=d, viewdirs=d,
                radii=ones, lossmult=ones, near=ones * 2, far=ones * 6)
    params = model.init(jax.random.PRNGKey(seed), None, rays)
    return jax.tree_util.tree_map(np.asarray, params)


def test_params_from_jax_loads_strict():
    params = _jax_vanilla_params()
    sd = interop.params_from_jax(params)
    model = VanillaNeRF(num_samples=8, num_importance=8, net_depth=DEPTH,
                        net_width=WIDTH)
    model.load_state_dict(sd, strict=True)
    k = params["params"]["fine"]["pts_5"]["kernel"]
    assert k.shape == (63 + WIDTH, WIDTH)
    np.testing.assert_array_equal(
        model.fine.pts_linears[5].weight.detach().numpy(), k.T)
    np.testing.assert_array_equal(
        model.coarse.temp_rgb.detach().numpy(),
        params["params"]["coarse"]["temp_rgb"])


def test_load_reference_tar_reads_exported_checkpoint(tmp_path):
    params = _jax_vanilla_params(seed=3)
    path = str(tmp_path / "000042.tar")
    export_checkpoint(params, 42, path, net_depth=DEPTH)
    sd, step = interop.load_reference_tar(path)
    assert step == 42
    want = interop.params_from_jax(params)
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
