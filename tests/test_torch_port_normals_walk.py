"""The design claim of kernel 6n's Hopper walk (`csrc/fwd_hopper.cuh`,
the normals tail): d(raw density)/d(means) needs the forward's ReLU masks
and nothing else of its activations.

`mask_walk` below is a plain PyTorch walk that keeps, of the forward, only
`act > 0` per trunk layer, with the kernel's rounding points: g starts at
the density head's weights, is masked and rounded to the compute type
before each product, the products and the encoding's gradient stay fp32,
and the IPE's Jacobian (damp cos(y), damp cos(y + pi/2), times 2^k,
summed over k) comes at the end. It is held, at depth 4 (no skip) and
depth 8 (the post-skip layer 5 reads the encoding again), width 64 and 16
IPE frequencies (the walk's 96-column encoding), in fp32 and bf16,
against rows 4-6 of the plain 6n (`fused_mip.plain_fwd_normals_T`,
autograd through the whole forward) and of the JAX kernel
(`fused_mip_mlp_normals_T`, interpret mode, as
`tests/test_torch_port_mip_normals.py` runs it).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.core import encoding
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from torch_port_shared import _one_torch_thread  # noqa: F401

N, WIDTH, NF = 200, 64, 16
# Each row's max|walk - reference| / max|reference|. The plain 6n rounds
# at the same points and differs in the order of its fp32 sums only (here
# it gives the walk's bits); so does the JAX kernel, whose packed trunk
# sums [pe | h] in one product (1.2e-7 to 2.0e-7 of a row here). A flipped
# bf16 rounding of g would move a row by ~1e-5; a wrong rounding point (g
# kept fp32 before the products) moves it by 3.3e-3 to 4.1e-3.
ROWS_REL = {"float32": 1e-5, "bfloat16": 1e-4}


def _safe_cos(y):
    """cos of mathx.safe_sin's argument: y, or its floored remainder by
    100 pi where |y| >= 100 pi."""
    t = 100 * math.pi
    return torch.cos(torch.where(y.abs() < t, y, torch.remainder(y, t)))


def mask_walk(flat, means, covs, views, depth, nf, cd, round_g=True):
    """d(raw density)/d(means) [N, 3] from the forward's ReLU masks only
    (round_g=False: g stays fp32 before the products, a wrong rounding
    point at bf16)."""
    cd = fm.as_dtype(cd)
    w = [fm._round(x.float(), cd) if i % 2 == 0 else x.float()
         for i, x in enumerate(flat)]
    post = fmip.post_skip_layers(depth)
    inputs = fm._round(encoding.integrated_pos_enc(means, covs, 0, nf), cd)
    k = inputs.shape[-1]
    masks, h = [], inputs
    for i in range(depth):  # the forward, as _mip_encoded runs it
        wi = w[2 * i]
        if i in post:
            h = torch.cat([inputs, h], -1)
            wi = torch.cat([wi[:, -k:], wi[:, :-k]], 1)
        h = fm._round(torch.relu(h @ wi.T + w[2 * i + 1]), cd)
        masks.append(h > 0)  # all the walk back keeps
    del h
    g = w[2 * depth][0].expand(means.shape[0], -1)  # the density head's wd
    g_sc = torch.zeros_like(inputs)
    for i in reversed(range(depth)):
        g_pre = g * masks[i]
        if round_g:
            g_pre = fm._round(g_pre, cd)
        wi = w[2 * i]
        if i == 0:
            g_sc = g_sc + g_pre @ wi
        elif i in post:  # [act | inputs] in the torch layout
            g_sc = g_sc + g_pre @ wi[:, -k:]
            g = g_pre @ wi[:, :-k]
        else:
            g = g_pre @ wi
    scale = 2.0 ** torch.arange(nf, dtype=torch.float32)
    y = means[:, None, :] * scale[:, None]  # [N, F, 3]
    damp = torch.exp(-0.5 * covs[:, None, :] * scale[:, None] ** 2)
    g_sin = g_sc[:, :3 * nf].reshape(-1, nf, 3)
    g_cos = g_sc[:, 3 * nf:].reshape(-1, nf, 3)
    per_k = (g_sin * damp * _safe_cos(y)
             + g_cos * damp * _safe_cos(y + 0.5 * math.pi))
    return (per_k * scale[:, None]).sum(1)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    means = (rs.rand(N, 3) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(N, 3) * 1e-3).astype(np.float32)
    views = rs.randn(N, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    return means, covs, views


def _weights(depth):
    """The flax MipMLP's flat weights (JAX layout) and the same weights in
    the port's flat torch layout."""
    m = JaxMipMLP(net_depth=depth, net_width=WIDTH, max_deg_point=NF,
                  disable_normals=False)
    z = jnp.zeros((2, 3))
    params = jax.tree_util.tree_map(np.asarray, m.init(
        jax.random.PRNGKey(depth), None, (z, z), z))
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(
        {"params": params["params"]}, depth)]
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = [sd[f"mlp.dense.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}"]
            for i in range(2 * (depth + 4))]
    return jflat, flat


def _row_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want).max(1)
            / np.abs(want).max(1).clip(1e-30)).max()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [4, 8])
def test_masks_alone_give_the_normals_rows(depth, cd):
    jflat, flat = _weights(depth)
    means, covs, views = _inputs(depth)
    m, c, v = (torch.tensor(x) for x in (means, covs, views))
    with torch.no_grad():
        walk = mask_walk(flat, m, c, v, depth, NF, cd).T
        plain = fmip.plain_fwd_normals_T(flat, m.T.contiguous(),
                                         c.T.contiguous(), v.T.contiguous(),
                                         depth, NF, cd)[4:]
    jax_rows = np.asarray(jfmip.fused_mip_mlp_normals_T(
        jflat, jnp.asarray(means.T), jnp.asarray(covs.T),
        jnp.asarray(views.T), net_depth=depth, num_freqs=NF, tile=128,
        interpret=True, compute_dtype=jnp.dtype(cd).type))[4:]
    assert walk.shape == (3, N) and torch.isfinite(walk).all()
    assert _row_rel(walk, plain) < ROWS_REL[cd]
    assert _row_rel(walk, jax_rows) < ROWS_REL[cd]


def test_a_wrong_rounding_point_is_seen():
    """The gate resolves the claim: the walk with g kept in fp32 (no round
    before the products) is further from the bf16 reference than
    ROWS_REL allows."""
    depth = 8
    _, flat = _weights(depth)
    m, c, v = (torch.tensor(x) for x in _inputs(depth))
    with torch.no_grad():
        plain = fmip.plain_fwd_normals_T(flat, m.T.contiguous(),
                                         c.T.contiguous(), v.T.contiguous(),
                                         depth, NF, "bfloat16")[4:]
        loose = mask_walk(flat, m, c, v, depth, NF, "bfloat16",
                          round_g=False).T
    assert _row_rel(loose, plain) > ROWS_REL["bfloat16"]
