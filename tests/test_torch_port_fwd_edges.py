"""The forwards on the Hopper walk (`csrc/fwd_hopper.cuh`) at the ragged
sizes the card tests give it: one point, a tile less one, a tile and one,
two tiles and one. The port's CPU path (the kernels' plain versions)
against the JAX package's Pallas kernels, run in interpret mode as the
JAX package's own tests run them, at width 64 and small encodings:
#1 and #6 (`fused_mlp_v2._fwd_pallas_T`, `fused_mip._fwd_pallas_T`) on
transposed streams, and the row-major forwards that take the same walk
under the row-major layout: #10 (`fused_mlp_v2._fwd_pallas`) and the v1
forward #12 / #13 (`fused_mlp.fused_mlp`, `fused_mlp_train._fwd_pallas`).
Inputs and weights are made from seeds with numpy and JAX's init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_train as jfmt
from consistentnerf_tpu.ops import fused_mlp_v2 as jv2
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

SIZES = (1, 127, 129, 257)
DEPTH, WIDTH, SKIPS, MR, MV = 4, 64, (2,), 4, 2
MIP_DEPTH, MIP_FREQS = 4, 4
# fp32: the bound the JAX kernels meet against their own oracles; bf16:
# max |port - JAX| / mean |JAX|, both sides rounding at the same points
# and differing in the order of their fp32 sums (the card gates' 2e-2).
FWD_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def nerf_params(request):
    """Seeded JAX NeRFMLP params (numpy leaves)."""
    return once_per_run(request, _nerf_params)


def _nerf_params():
    mlp = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS)
    params = mlp.init(jax.random.PRNGKey(0), jnp.zeros((2, 3 + 6 * MR)),
                      jnp.zeros((2, 3 + 6 * MV)))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def nerf(nerf_params):
    """Seeded JAX NeRFMLP params as the JAX flat list and the port's."""
    params = nerf_params
    jflat = [jnp.asarray(w) for w in jfm.flatten_params(params, True,
                                                        DEPTH)]
    jflat = [w[None, :] if w.ndim == 1 else w for w in jflat]
    sd = interop.mlp_state_from_jax(params["params"])
    return jflat, fm.flatten_params(sd, True, DEPTH)


@pytest.fixture(scope="module")
def mip(request):
    return once_per_run(request, _mip)


def _mip():
    m = JaxMipMLP(net_depth=MIP_DEPTH, net_width=WIDTH,
                  max_deg_point=MIP_FREQS, disable_normals=True)
    z = jnp.zeros((2, 3))
    params = m.init(jax.random.PRNGKey(0), None, (z, z), z)
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(params,
                                                              MIP_DEPTH)]
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = [sd[f"mlp.dense.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}"]
            for i in range(2 * (MIP_DEPTH + 4))]
    return jflat, flat


def _nerf_streams(n):
    rs = np.random.RandomState(n)
    pts = rs.uniform(-2, 2, (3, n)).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    return pts, views / np.linalg.norm(views, axis=0, keepdims=True)


def _mip_streams(n):
    rs = np.random.RandomState(n)
    means = (rs.rand(3, n) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(3, n) * 1e-3).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    return means, covs, views / np.linalg.norm(views, axis=0, keepdims=True)


def _check(got, want, dtype):
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FWD_TOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).mean() < BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_fwd_T_matches_jax_kernel_at_ragged_sizes(nerf, n, dtype):
    jflat, flat = nerf
    pts, views = _nerf_streams(n)
    want = np.asarray(jv2._fwd_pallas_T(
        jflat, jnp.asarray(pts), jnp.asarray(views), DEPTH, SKIPS, MR, MV,
        128, True, jnp.float32 if dtype == "float32" else jnp.bfloat16))
    got = v2.plain_fwd_T(flat, torch.from_numpy(pts),
                         torch.from_numpy(views), DEPTH, SKIPS, MR, MV, dtype)
    _check(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_mip_plain_fwd_matches_jax_kernel_at_ragged_sizes(mip, n, dtype):
    """The MipMLP at width 64: its 128-wide view layer is wider than its
    trunk, the shape the card's width-64 walk takes."""
    jflat, flat = mip
    m, c, v = _mip_streams(n)
    want = np.asarray(jfmip._fwd_pallas_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v), MIP_DEPTH, 4,
        MIP_FREQS, 4, 128, True,
        jnp.float32 if dtype == "float32" else jnp.bfloat16))
    got = fmip.plain_fwd_T(flat, torch.from_numpy(m), torch.from_numpy(c),
                           torch.from_numpy(v), MIP_DEPTH, MIP_FREQS, dtype)
    _check(got.numpy(), want, dtype)


# The row-major forwards: the JAX kernels' tile (ragged sizes past it pad
# the last grid step) and the functions that take [N, 3] streams.
ROW_TILE = 128


def _row_streams(n):
    return tuple(np.ascontiguousarray(x.T) for x in _nerf_streams(n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_fwd_row_matches_jax_row_kernel_at_ragged_sizes(nerf, n,
                                                              dtype):
    """#10: `plain_fwd_row` (the CPU path of `fused_mlp_v2.fwd`) against
    the JAX `_fwd_pallas` on [N, 3] streams, [N, 4] out."""
    jflat, flat = nerf
    pts, views = _row_streams(n)
    want = np.asarray(jv2._fwd_pallas(
        jflat, jnp.asarray(pts), jnp.asarray(views), DEPTH, SKIPS, MR, MV,
        ROW_TILE, True, jnp.float32 if dtype == "float32" else jnp.bfloat16))
    got = v2.plain_fwd_row(flat, torch.from_numpy(pts),
                           torch.from_numpy(views), DEPTH, SKIPS, MR, MV,
                           dtype)
    _check(got.numpy(), want, dtype)
    before = v2.row_launches
    assert torch.equal(v2.fwd(flat, torch.from_numpy(pts),
                              torch.from_numpy(views), DEPTH, SKIPS, MR, MV,
                              dtype), got)
    assert v2.row_launches == before  # CPU tensors: no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_v1_plain_fwd_matches_jax_v1_kernels_at_ragged_sizes(
        nerf_params, nerf, n, dtype):
    """#12 / #13: the v1 forward's plain version, the CPU path of both
    `fused_mlp.fused_mlp` and `fused_mlp_train.forward`, against the JAX
    render kernel `fused_mlp.fused_mlp` and the train forward
    `fused_mlp_train._fwd_pallas` on the same [N, 3] streams; at these
    shapes (view branch, no skip into the heads) the JAX v1 kernels and #10
    compute one function."""
    jflat, flat = nerf
    pts, views = _row_streams(n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want12 = np.asarray(jfm.fused_mlp(
        nerf_params, jnp.asarray(pts), jnp.asarray(views), net_depth=DEPTH,
        skips=SKIPS, multires=MR, multires_views=MV, tile=ROW_TILE,
        interpret=True, compute_dtype=jdt))
    want13 = np.asarray(jfmt._fwd_pallas(
        tuple(jflat), jnp.asarray(pts), jnp.asarray(views), DEPTH, SKIPS,
        MR, MV, ROW_TILE, True, jdt))
    pts_t, views_t = torch.from_numpy(pts), torch.from_numpy(views)
    before = (fm.launches, fmt.fwd_launches)
    got12 = fm.fused_mlp(flat, pts_t, views_t, net_depth=DEPTH, skips=SKIPS,
                         multires=MR, multires_views=MV, compute_dtype=dtype)
    got13 = fmt.forward(flat, pts_t, views_t, DEPTH, SKIPS, MR, MV, dtype)
    assert (fm.launches, fmt.fwd_launches) == before
    assert torch.equal(got12, got13)
    assert torch.equal(got13, fmt.plain_forward(flat, pts_t, views_t, DEPTH,
                                                SKIPS, MR, MV, dtype))
    _check(got12.numpy(), want12, dtype)
    _check(got13.numpy(), want13, dtype)
