"""The port's kernels on the card, held against their plain versions or
their packed walks: the NeRF kernels #1-#3 and the mip kernels #5-#7.

Every test here needs a CUDA device and skips without one. The module
imports torch and the port only, so it also runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.models.mlp import NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.train import render as render_lib

SKIPS, MR, MV = (4,), 10, 4
# max|kernel - plain| / mean|plain|: bf16 operands with fp32 sums on both
# sides, so only the sum order (and the bf16 rounding it flips) differs;
# at fp32 only the sum order.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernel has no CPU mode)")
    fm.strict_fp32(torch.device("cuda"))
    return torch.device("cuda")


def _inputs(n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(3, n, generator=g) * 4 - 2
    views = torch.randn(3, n, generator=g)
    views = views / views.norm(dim=0, keepdim=True)
    return pts.to(device), views.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain(cuda_device, width, dtype):
    mlp = NeRFMLP(net_depth=8, net_width=width)
    mlp.reset_parameters(torch.Generator().manual_seed(1))
    flat = [w.to(cuda_device) for w in fm.flatten_params(mlp)]
    # 5000 points: 40 tiles of 128 (bf16) or 79 of 64 (fp32), the last
    # one ragged.
    pts_T, views_T = _inputs(5000, cuda_device)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    before = v2.launches
    got = v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV, dtype)
    torch.cuda.synchronize()
    assert v2.launches == before + 1
    want = v2.plain_fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV, dtype)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[dtype]


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    mlp = NeRFMLP(net_depth=8, net_width=32)
    flat = [w.to(cuda_device) for w in fm.flatten_params(mlp)]
    pts_T, views_T = _inputs(100, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        v2.fwd_T(flat, pts_T.T.contiguous().T, views_T, 8, SKIPS, MR, MV,
                 "float32")
    cpu_packed = v2.pack([w.cpu() for w in flat], 8, SKIPS, MR, MV,
                         "float32")
    with pytest.raises(ValueError, match="device"):
        v2.fwd_T(cpu_packed, pts_T, views_T, 8, SKIPS, MR, MV, "float32")


@pytest.mark.cuda
def test_render_goes_through_the_kernel(cuda_device):
    """build_render_fn at bf16 on the card: one launch per level and
    chunk, and the image agrees with the plain (module) render."""
    cfg = configs.Config(netwidth=64, N_samples=16, N_importance=16,
                         white_bkgd=True, compute_dtype="bfloat16",
                         render_chunk_size=256, use_fused_render=True)
    model = make_model(cfg, cuda_device).eval()
    g = torch.Generator().manual_seed(2)
    n = 600
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(n, 1)
    rays = Rays(origins=-4 * d, directions=d, viewdirs=d, radii=ones,
                lossmult=ones, near=ones * 2, far=ones * 6).map(
        lambda x: x.to(cuda_device).contiguous())
    v2.launches = 0
    fused = render_lib.build_render_fn(model, cfg)(rays)
    torch.cuda.synchronize()
    assert v2.launches == 2 * 3  # 600 rays in chunks of 256
    plain = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(rays)
    assert (fused["rgb"] - plain["rgb"]).abs().mean().item() < 2e-3


# ------------------------- the train kernels -----------------------------

from consistentnerf_tpu_torch.ops import fused_onepass as op  # noqa: E402

# Kernel vs the packed walk (the same rounding points, run with torch on
# the card): the largest ||diff|| / ||walk|| over the grad tensors. Only
# the order of the fp32 sums differs. At bf16 that order flips the bf16
# rounding of an activation or gradient now and then; each flip perturbs
# the next layer's 256 sums, which flips more of them, so at width 256
# the grads of the first layers end up ~1e-2 apart (1.3e-2 measured on an
# H100 for 3000 points and unit cotangents) while fp32 agrees to ~1e-6.
TRAIN_TOL = {"bfloat16": 5e-2, "float32": 1e-5}


def _rel(got, want):
    return max((torch.linalg.norm(a - b)
                / torch.linalg.norm(b).clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def _mlp_flat(width, device, seed=1):
    mlp = NeRFMLP(net_depth=8, net_width=width)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return [w.detach().to(device) for w in fm.flatten_params(mlp)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_kernel_matches_packed_walk(cuda_device, width, dtype):
    flat = _mlp_flat(width, cuda_device)
    n = 3000  # 4 chunks of 768 points, the last one ragged
    pts_T, views_T = _inputs(n, cuda_device)
    g = torch.randn(4, n, generator=torch.Generator().manual_seed(3)).to(
        cuda_device)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    before = v2.bwd_launches
    got = v2.bwd_T(packed, pts_T, views_T, g, 8, SKIPS, MR, MV, dtype)
    torch.cuda.synchronize()
    assert v2.bwd_launches == before + 1
    want = v2.packed_bwd_reference_T(packed, pts_T, views_T, g)
    assert all(torch.isfinite(x).all() for x in got)
    print(f"bwd {dtype} W={width}: rel {_rel(got, want):.3e}")
    assert _rel(got, want) < TRAIN_TOL[dtype]
    again = v2.bwd_T(packed, pts_T, views_T, g, 8, SKIPS, MR, MV, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [64, 192, 24])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_kernel_matches_packed_walk(cuda_device, seg, dtype):
    flat = _mlp_flat(64, cuda_device, seed=2)
    g = torch.Generator().manual_seed(4)
    n_rays = 37  # a ragged last chunk
    o = torch.randn(n_rays, 3, generator=g)
    d = torch.randn(n_rays, 3, generator=g)
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2, -1).values
    dev = cuda_device
    o, d, z = o.to(dev), d.to(dev), z.to(dev)
    vd = d / d.norm(dim=-1, keepdim=True)
    pts_T, views_T = op._pts_views(o.T, d.T, vd.T, z)
    rows = [torch.rand(n_rays, generator=g).to(dev) for _ in range(3)]
    tgt = torch.rand(n_rays, 3, generator=g).to(dev)
    args = (pts_T, views_T, z, d.norm(dim=-1), rows[0], tgt, rows[1],
            rows[2] * 4 + 2)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    before = op.launches
    out, dw = op.onepass_level(packed, *args, white_bkgd=True,
                               compute_dtype=dtype)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want_out, want_dw = op.packed_onepass_reference(packed, *args, True)
    assert torch.isfinite(out).all()
    row_err = (out - want_out).abs().max().item()
    print(f"onepass {dtype} S={seg}: rows {row_err:.3e}, "
          f"dW rel {_rel(dw, want_dw):.3e}")
    assert (out - want_out).abs().max().item() < 1e-3
    assert _rel(dw, want_dw) < TRAIN_TOL[dtype]


# --------------------------- the mip kernels -----------------------------

# Kernel dW vs the plain version (autograd through the MipMLP body): the
# chip_smoke.py bounds. fp32: only the sum order differs (the plain body
# sums the post-skip layer in the kernels' order); bf16: the plain
# version's autograd rounds its cotangents elsewhere than the kernels.
PLAIN_DW_TOL = {"bfloat16": 5e-2, "float32": 1e-4}

from consistentnerf_tpu_torch.models.mlp import MipMLP  # noqa: E402
from consistentnerf_tpu_torch.ops import fused_mip as fmip  # noqa: E402


def _mip_flat(width, device, seed=1):
    mlp = MipMLP(net_depth=8, net_width=width)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return [w.detach().to(device) for w in fmip.flatten_mip_params(mlp)]


def _mip_inputs(n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    means = torch.rand(3, n, generator=g) * 3 - 1.5
    covs = torch.rand(3, n, generator=g) * 1e-4
    views = torch.randn(3, n, generator=g)
    views = views / views.norm(dim=0, keepdim=True)
    return means.to(device), covs.to(device), views.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mip_fwd_kernel_matches_plain(cuda_device, width, dtype):
    """#6 at width 64 (its view layer, 128 wide, is wider than the trunk)
    and 256; a second launch is bit-identical to the first."""
    flat = _mip_flat(width, cuda_device)
    means, covs, views = _mip_inputs(5000, cuda_device)
    packed = fmip.pack(flat, 8, 16, dtype)
    before = fmip.launches
    got = fmip.fwd_T(packed, means, covs, views, 8, 16, dtype)
    torch.cuda.synchronize()
    assert fmip.launches == before + 1
    want = fmip.plain_fwd_T(packed, means, covs, views, 8, 16, dtype)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[dtype]
    assert torch.equal(got, fmip.fwd_T(packed, means, covs, views, 8, 16,
                                       dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mip_bwd_kernel_matches_packed_walk(cuda_device, width, dtype):
    flat = _mip_flat(width, cuda_device)
    n = 3000  # 4 chunks of 768 points, the last one ragged
    means, covs, views = _mip_inputs(n, cuda_device)
    g = 1e-2 * torch.randn(4, n, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda_device)
    packed = fmip.pack(flat, 8, 16, dtype)
    before = fmip.bwd_launches
    got = fmip.bwd_T(packed, means, covs, views, g, 8, 16, dtype)
    torch.cuda.synchronize()
    assert fmip.bwd_launches == before + 1
    want = v2.packed_bwd_reference_T(packed, means, views, g, covs)
    assert all(torch.isfinite(x).all() for x in got)
    plain = fmip.plain_bwd_T(packed, means, covs, views, g, 8, 16, dtype)
    print(f"mip bwd {dtype} W={width}: rel {_rel(got, want):.3e}, vs "
          f"plain {_rel(got, plain):.3e}")
    assert _rel(got, want) < TRAIN_TOL[dtype]
    assert _rel(got, plain) < PLAIN_DW_TOL[dtype]
    again = fmip.bwd_T(packed, means, covs, views, g, 8, 16, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_mip_kernel_matches_packed_walk(cuda_device, noise, dtype):
    """#5 on 37 rays of 96 samples (a ragged last chunk), with and without
    a density-noise row; a second launch is bit-identical."""
    flat = _mip_flat(256, cuda_device, seed=2)
    g = torch.Generator().manual_seed(4)
    n_rays, seg, dev = 37, 96, cuda_device
    t = torch.sort(torch.rand(n_rays, seg + 1, generator=g) * 4 + 2,
                   -1).values.to(dev)
    dn = (0.5 + torch.rand(n_rays, generator=g)).to(dev)
    means, covs, _ = _mip_inputs(n_rays * seg, dev, seed=5)
    views = _mip_inputs(n_rays, dev, seed=6)[2].repeat_interleave(
        seg, 1).contiguous()
    rows = [torch.rand(n_rays, generator=g).to(dev) for _ in range(3)]
    tgt = torch.rand(n_rays, 3, generator=g).to(dev)
    nz = torch.randn(n_rays, seg, generator=g).to(dev) if noise else None
    args = (means, covs, views, 0.5 * (t[:, 1:] + t[:, :-1]),
            (t[:, 1:] - t[:, :-1]) * dn[:, None], t[:, 0].contiguous(),
            t[:, -1].contiguous(), rows[0], tgt, rows[1], rows[2] * 4 + 2,
            nz)
    packed = fmip.pack(flat, 8, 16, dtype)
    before = op.mip_launches
    out, dw = op.onepass_mip_level(packed, *args, net_depth=8, num_freqs=16,
                                   white_bkgd=True, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert op.mip_launches == before + 1
    want_out, want_dw = op.packed_onepass_mip_reference(packed, *args,
                                                        white_bkgd=True)
    assert torch.isfinite(out).all()
    row_err = (out - want_out).abs().max().item()
    print(f"onepass mip {dtype} noise={noise}: rows {row_err:.3e}, "
          f"dW rel {_rel(dw, want_dw):.3e}")
    assert row_err < 1e-3
    assert _rel(dw, want_dw) < TRAIN_TOL[dtype]
    plain_out, plain_dw = op.plain_onepass_mip_level(
        packed, *args, net_depth=8, num_freqs=16, white_bkgd=True,
        compute_dtype=fm.as_dtype(dtype))
    assert (out - plain_out).abs().max().item() < 1e-3
    assert _rel(dw, plain_dw) < PLAIN_DW_TOL[dtype]
    out2, dw2 = op.onepass_mip_level(packed, *args, net_depth=8,
                                     num_freqs=16, white_bkgd=True,
                                     compute_dtype=dtype)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw2))


@pytest.mark.cuda
def test_mip_render_goes_through_the_kernel(cuda_device):
    """The mip render at bf16 on the card: one #6 launch per level and
    chunk, and the image agrees with the plain (module) render."""
    cfg = configs.Config(backbone="mipnerf", netwidth=64, mip_num_samples=16,
                         white_bkgd=True, compute_dtype="bfloat16",
                         render_chunk_size=256, use_fused_render=True)
    model = make_model(cfg, cuda_device).eval()
    g = torch.Generator().manual_seed(2)
    n = 600
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(n, 1)
    rays = Rays(origins=-4 * d, directions=d, viewdirs=d,
                radii=ones * 2e-3, lossmult=ones, near=ones * 2,
                far=ones * 6).map(lambda x: x.to(cuda_device).contiguous())
    fmip.launches = 0
    fused = render_lib.build_render_fn(model, cfg)(rays)
    torch.cuda.synchronize()
    assert fmip.launches == 2 * 3  # 600 rays in chunks of 256
    plain = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(rays)
    assert (fused["rgb"] - plain["rgb"]).abs().mean().item() < 2e-3
