"""The port's kernels on the card, held against their plain versions or
their packed walks: the NeRF kernels #1-#4, the mip kernels #5-#7 and
6n (#6 with normals), the resampling kernels #8 and #9, and the
row-major kernels #10, #11, #15, #16 (also against the transposed
kernels on the same points), with the two-call step's launches, the v1
kernels #12-#14 with the v1 routes' launches, the hard masks on the
card against the CPU, the bf16 Hopper walk of #1 and #6
(`csrc/fwd_hopper.cuh`): its plans, ragged sizes and widths, repeats and
the alignment its weight loads need, and #2, #7, #11 and #14 on the
level walk of `csrc/level_train.cuh`: their plans and ragged sizes, #11
bit for bit against #2 and #14 against #11 on the same points.

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


# Ragged sizes of the weight-grad kernels #2 and #7: one point, a chunk's
# first 64-row sub-tile less one and plus one, a 768-point chunk plus
# one, 4 chunks with a ragged last one, and the one-pass step's fine
# patch launch less one point. Wherever a chunk ends inside a 64-row
# sub-tile, its padded rows hold activations (bias through ReLU) and
# must meet a zero cotangent.
RAGGED_BWD_N = (1, 63, 65, 769, 3000, 196_607)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED_BWD_N)
@pytest.mark.parametrize("kernel", ["mlp", "mip"])
def test_bwd_kernels_at_ragged_sizes(cuda_device, kernel, n):
    """#2 and #7 in bf16 at width 256 (the level walk in mode 2) against
    their packed walks at ragged sizes, and a second launch bit-identical
    to the first."""
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(4, n, generator=gen).to(cuda_device)
    if kernel == "mlp":
        packed = v2.pack(_mlp_flat(256, cuda_device), 8, SKIPS, MR, MV,
                         "bfloat16")
        pts_T, views_T = _inputs(n, cuda_device, seed=n)

        def run():
            return v2.bwd_T(packed, pts_T, views_T, g, 8, SKIPS, MR, MV,
                            "bfloat16")
        want = v2.packed_bwd_reference_T(packed, pts_T, views_T, g)
    else:
        packed = fmip.pack(_mip_flat(256, cuda_device), 8, 16, "bfloat16")
        means, covs, views = _mip_inputs(n, cuda_device, seed=n)
        g = 1e-2 * g

        def run():
            return fmip.bwd_T(packed, means, covs, views, g, 8, 16,
                              "bfloat16")
        want = v2.packed_bwd_reference_T(packed, means, views, g, covs)
    got = run()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    print(f"{kernel} bwd N={n}: rel {_rel(got, want):.3e}")
    assert _rel(got, want) < TRAIN_TOL["bfloat16"]
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


def _bwd_plan(kernel, n, width, bf16=1):
    import ctypes

    out = (ctypes.c_longlong * 9)()
    if kernel == "mlp":
        fn = v2._entry(v2.BWD_KERNEL, "fused_mlp_bwd_plan", 0, 7)
        assert fn(n, 8, width, 16, MR, MV, bf16, out) == 0
    else:
        fn = v2._entry(fmip.BWD_KERNEL, "fused_mip_bwd_plan", 0, 8)
        assert fn(n, 8, width, 128, 16, 16, 4, bf16, out) == 0
    return list(out)


@pytest.mark.cuda
def test_bwd_plan_picks_the_level_walk(cuda_device):
    """The bf16 plans of #2 and #7 take the level walk (wgmma products, the
    dW GEMM) at widths 64 and 256 and train_block with its dW pass at
    width 320 and in fp32, and on a 132-SM card they give the one-pass
    steps' patch launches full waves: no block walks more rows than the
    launch's points spread evenly over the grid need."""
    for kernel in ("mlp", "mip"):
        for width in (64, 256):
            assert _bwd_plan(kernel, 196_608, width)[8] == 1
        assert _bwd_plan(kernel, 3000, 320)[8] == 0
        fp32 = _bwd_plan(kernel, 3000, 256, bf16=0)
        assert fp32[8] == 0 and fp32[5:8] == [0, 0, 0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, n in (("mlp", 196_608), ("mlp", 65_536), ("mip", 98_304)):
        plan = _bwd_plan(kernel, n, 256)
        chunks = -(-n // plan[4])
        assert plan[0] == min(chunks, sms)
        if sms == 132:  # an H100 SXM
            rows = -(-plan[4] // 64) * 64
            assert -(-chunks // sms) * rows == -(-n // (sms * 64)) * 64
    if sms == 132:
        assert _bwd_plan("mlp", 196_608, 256)[4] == 768


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("seg", [64, 192, 24])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_kernel_matches_packed_walk(cuda_device, width, seg, dtype):
    """#3 on 37 rays (at 24 samples the level plan takes 2 rays a chunk,
    so the last chunk is ragged); in bf16 a second launch is
    bit-identical."""
    flat = _mlp_flat(width, cuda_device, seed=2)
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
    print(f"onepass {dtype} W={width} S={seg}: rows {row_err:.3e}, "
          f"dW rel {_rel(dw, want_dw):.3e}")
    if width == 64:
        assert row_err < 1e-3
    else:
        # Width 256 sums 4x more products into each pre-activation, so
        # more bf16 roundings flip between the two sum orders (1.4e-3
        # absolute at S=24 on an H100): each row is held as chip_smoke.py
        # holds the main path's, max|diff| / max|walk| (ROWS_TOL there).
        rows_rel = ((out - want_out).abs().amax(1)
                    / want_out.abs().amax(1).clamp_min(1e-30)).max().item()
        assert rows_rel < {"bfloat16": 5e-3, "float32": 1e-4}[dtype]
    assert _rel(dw, want_dw) < TRAIN_TOL[dtype]
    if dtype == "bfloat16":
        out2, dw2 = op.onepass_level(packed, *args, white_bkgd=True,
                                     compute_dtype=dtype)
        assert torch.equal(out, out2)
        assert all(torch.equal(a, b) for a, b in zip(dw, dw2))


def _level_plan(n_rays, seg, width):
    import ctypes

    out = (ctypes.c_longlong * 9)()
    assert op._kernel()[0](n_rays, seg, 8, width, 16, MR, MV, 1, out) == 0
    return list(out)


@pytest.mark.cuda
def test_onepass_level_plan_picks_the_products(cuda_device):
    """The bf16 level plan takes the level walk (wgmma products, the dW
    GEMM) up to width 256 and the legacy walk with its dW pass past it
    (the weight ring holds 256 columns), and sizes chunks so that the
    last wave of the fine and coarse levels of the flagship step is
    full."""
    fine, coarse = _level_plan(4096, 192, 256), _level_plan(4096, 64, 256)
    assert fine[8] == 1 and coarse[8] == 1
    assert _level_plan(37, 24, 320)[8] == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plan, rays in ((fine, 4096), (coarse, 4096)):
        chunks = -(-rays * (192 if plan is fine else 64) // plan[4])
        assert plan[0] == min(chunks, sms)
    if sms == 132:  # an H100 SXM
        assert (fine[4], coarse[4]) == (768, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_wide_mlp_matches_packed_walk(cuda_device, dtype):
    """At width 320 the bf16 level runs the legacy walk of the other train
    kernels; it still matches the packed walk, and a second bf16 launch
    is bit-identical."""
    mlp = NeRFMLP(net_depth=8, net_width=320)
    mlp.reset_parameters(torch.Generator().manual_seed(2))
    flat = [w.detach().to(cuda_device) for w in fm.flatten_params(mlp)]
    g = torch.Generator().manual_seed(4)
    n_rays, seg, dev = 37, 24, cuda_device
    o = torch.randn(n_rays, 3, generator=g).to(dev)
    d = torch.randn(n_rays, 3, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2,
                   -1).values.to(dev)
    pts_T, views_T = op._pts_views(o.T, d.T,
                                   (d / d.norm(dim=-1, keepdim=True)).T, z)
    rows = [torch.rand(n_rays, generator=g).to(dev) for _ in range(3)]
    tgt = torch.rand(n_rays, 3, generator=g).to(dev)
    args = (pts_T, views_T, z, d.norm(dim=-1), rows[0], tgt, rows[1],
            rows[2] * 4 + 2)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    out, dw = op.onepass_level(packed, *args, white_bkgd=True,
                               compute_dtype=dtype)
    want_out, want_dw = op.packed_onepass_reference(packed, *args, True)
    print(f"onepass {dtype} W=320: rows "
          f"{(out - want_out).abs().max().item():.3e}, dW rel "
          f"{_rel(dw, want_dw):.3e}")
    assert (out - want_out).abs().max().item() < 1e-3
    assert _rel(dw, want_dw) < TRAIN_TOL[dtype]
    if dtype == "bfloat16":
        out2, dw2 = op.onepass_level(packed, *args, white_bkgd=True,
                                     compute_dtype=dtype)
        assert torch.equal(out, out2)
        assert all(torch.equal(a, b) for a, b in zip(dw, dw2))


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
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_mip_kernel_matches_packed_walk(cuda_device, width, noise,
                                                dtype):
    """#5 on 37 rays of 96 samples, with and without a density-noise row,
    at width 64 (its view layer, 128 wide, is wider than the trunk) and
    256; a second launch is bit-identical."""
    flat = _mip_flat(width, cuda_device, seed=2)
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
    print(f"onepass mip {dtype} W={width} noise={noise}: rows "
          f"{row_err:.3e}, "
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


# ------------------- #4, 6n, #8, #9 (the switched paths) -------------------

from consistentnerf_tpu_torch.ops import pdf_merge  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [64, 192, 24])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_render_level_kernel_matches_plain(cuda_device, seg, dtype):
    """#4 on 37 rays (a ragged last chunk): each row's max|diff| /
    max|plain| within the one-pass rows' bounds; bit-identical again."""
    flat = _mlp_flat(64, cuda_device, seed=2)
    g = torch.Generator().manual_seed(4)
    n_rays, dev = 37, cuda_device
    o = torch.randn(n_rays, 3, generator=g).to(dev)
    d = torch.randn(n_rays, 3, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2,
                   -1).values.to(dev)
    pts_T, views_T = op._pts_views(o.T, d.T, (d / d.norm(dim=-1,
                                                         keepdim=True)).T, z)
    z_row = z.reshape(1, -1).contiguous()
    dn_row = op._rep_row(d.norm(dim=-1), seg).contiguous()
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    kw = dict(seg=seg, net_depth=8, skips=SKIPS, multires=MR,
              multires_views=MV, white_bkgd=True, compute_dtype=dtype)
    before = op.render_launches
    got = op.render_level_T(packed, pts_T, views_T, z_row, dn_row, **kw)
    torch.cuda.synchronize()
    assert op.render_launches == before + 1
    want = op.plain_render_level_T(packed, pts_T, views_T, z_row, dn_row,
                                   **kw)
    assert torch.isfinite(got).all()
    rows = ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp_min(1e-30)).max().item()
    print(f"render_level {dtype} S={seg}: rows {rows:.3e}")
    assert rows < {"bfloat16": 5e-3, "float32": 1e-4}[dtype]
    assert torch.equal(got, op.render_level_T(packed, pts_T, views_T, z_row,
                                              dn_row, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mip_normals_kernel_matches_plain(cuda_device, width, dtype):
    """6n on 3000 points (4 chunks, the last ragged): rows 0-3 as #6's;
    rows 4-6 (d raw density / d means) in fp32 each within 1e-4 of the
    plain version's largest value, in bf16 within 1e-3 of it on average
    and no further from the fp32 function than the bf16 plain version
    (chip_smoke.py's NORMALS_BF16_RATIO: the walk's ReLU masks follow
    the forward's bf16 roundings); bit-identical again."""
    flat = _mip_flat(width, cuda_device)
    means, covs, views = _mip_inputs(3000, cuda_device)
    packed = fmip.pack(flat, 8, 16, dtype)
    before = fmip.normals_launches
    got = fmip.fused_mip_mlp_normals_T(packed, means, covs, views, 8, 16,
                                       dtype)
    torch.cuda.synchronize()
    assert fmip.normals_launches == before + 1
    want = fmip.plain_fwd_normals_T(packed, means, covs, views, 8, 16, dtype)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:4], fmip.fwd_T(packed, means, covs, views, 8,
                                           16, dtype))
    diff = (got[4:] - want[4:]).abs()
    rows = (diff.amax(1) / want[4:].abs().amax(1)).max().item()
    mean = (diff.mean() / want[4:].abs().mean()).item()
    print(f"mip normals {dtype} W={width}: rows {rows:.3e}, mean {mean:.3e}")
    if dtype == "float32":
        assert rows < 1e-4
    else:
        exact = fmip.plain_fwd_normals_T(fmip.pack(flat, 8, 16, "float32"),
                                         means, covs, views, 8, 16,
                                         "float32")[4:]
        k_err = (got[4:] - exact).abs().mean().item()
        p_err = (want[4:] - exact).abs().mean().item()
        print(f"  from fp32: kernel {k_err:.3e}, plain bf16 {p_err:.3e}")
        assert mean < 1e-3 and k_err <= 1.25 * p_err
    assert torch.equal(got, fmip.fused_mip_mlp_normals_T(
        packed, means, covs, views, 8, 16, dtype))


@pytest.mark.cuda
def test_tail_plans_take_the_walk_in_bf16(cuda_device):
    """6n at the render chunk (786,432 points) and #4 at the fine and the
    coarse render chunk (8192 x 192, 8192 x 64) take the Hopper walk's
    tails in bf16 (6n with no workspace, #4 with the shared memory of the
    wrappers' mirror), mode 5 and the old kernel in fp32."""
    mip = fmip.flatten_mip_params(MipMLP(net_depth=8, net_width=256))
    nerf = fm.flatten_params(NeRFMLP())
    for dt in ("bfloat16", "float32"):
        bf = dt == "bfloat16"
        plan = fmip.normals_plan(fmip.pack(mip, 8, 16, dt), 8192 * 96)
        assert plan["hopper"] == bf and (plan["workspace"] == 0) == bf
        assert plan["masks_in_registers"] == bf
        packed = v2.pack(nerf, 8, SKIPS, MR, MV, dt)
        for seg in (192, 64):
            plan = op.render_plan(packed, 8192, seg)
            assert plan["hopper"] == bf
            if bf:
                want = op.render_smem_bytes(packed, seg)
                assert (plan["smem_bytes"], plan["stages"]) == want[:2]
                assert (plan["group_points"], plan["group_tiles"],
                        plan["group_rays"]) == op.render_group(seg)
    # An S whose group's heads do not fit keeps the old kernel.
    packed = v2.pack(nerf, 8, SKIPS, MR, MV, "bfloat16")
    assert not op.render_plan(packed, 100, 150)["hopper"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 198 * 128 - 50])
def test_normals_walk_at_ragged_sizes(cuda_device, n):
    """6n in bf16 at 8x256 on the Hopper walk: rows 0-3 bit-identical to
    #6, a second launch bit-identical, rows 4-6 within 1e-3 of the plain
    version on average and no further from the fp32 function than the
    bf16 plain version (the gates of test_mip_normals_kernel_matches_plain
    at one point, a tile less and more one, a half-empty last wave)."""
    flat = _mip_flat(256, cuda_device)
    means, covs, views = _mip_inputs(n, cuda_device, seed=3)
    packed = fmip.pack(flat, 8, 16, "bfloat16")
    assert fmip.normals_plan(packed, n)["hopper"] == 1
    got = fmip.fused_mip_mlp_normals_T(packed, means, covs, views, 8, 16,
                                       "bfloat16")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[:4], fmip.fwd_T(packed, means, covs, views, 8,
                                           16, "bfloat16"))
    assert torch.equal(got, fmip.fused_mip_mlp_normals_T(
        packed, means, covs, views, 8, 16, "bfloat16"))
    want = fmip.plain_fwd_normals_T(packed, means, covs, views, 8, 16,
                                    "bfloat16")[4:]
    exact = fmip.plain_fwd_normals_T(fmip.pack(flat, 8, 16, "float32"),
                                     means, covs, views, 8, 16,
                                     "float32")[4:]
    mean = ((got[4:] - want).abs().mean() / want.abs().mean()).item()
    k_err = (got[4:] - exact).abs().mean().item()
    p_err = (want - exact).abs().mean().item()
    print(f"6n N={n}: mean {mean:.3e}, from fp32 kernel {k_err:.3e}, "
          f"plain {p_err:.3e}")
    assert mean < 1e-3 and k_err <= 1.25 * p_err


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 3, 395])
@pytest.mark.parametrize("seg", [64, 192])
def test_render_walk_at_ragged_rays(cuda_device, seg, n_rays):
    """#4 in bf16 at 8x256 on the Hopper walk (groups of 2 rays at S = 64
    and 192): one ray, a group and a half, and 198 groups (132 + 66, the
    last one ray). Each row within the one-pass rows' 5e-3 of the plain
    version, a second launch bit-identical, and rows 3-5 within 1e-5 of
    the plain compositing of #1's raw heads on the same points."""
    flat = _mlp_flat(256, cuda_device, seed=2)
    g = torch.Generator().manual_seed(5)
    dev = cuda_device
    o = torch.randn(n_rays, 3, generator=g).to(dev)
    d = torch.randn(n_rays, 3, generator=g).to(dev)
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2,
                   -1).values.to(dev)
    pts_T, views_T = op._pts_views(o.T, d.T, (d / d.norm(dim=-1,
                                                         keepdim=True)).T, z)
    z_row = z.reshape(1, -1).contiguous()
    dn_row = op._rep_row(d.norm(dim=-1), seg).contiguous()
    packed = v2.pack(flat, 8, SKIPS, MR, MV, "bfloat16")
    assert op.render_plan(packed, n_rays, seg)["hopper"] == 1
    kw = dict(seg=seg, net_depth=8, skips=SKIPS, multires=MR,
              multires_views=MV, white_bkgd=True, compute_dtype="bfloat16")
    got = op.render_level_T(packed, pts_T, views_T, z_row, dn_row, **kw)
    torch.cuda.synchronize()
    want = op.plain_render_level_T(packed, pts_T, views_T, z_row, dn_row,
                                   **kw)
    assert torch.isfinite(got).all()
    rows = ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp_min(1e-30)).max().item()
    assert rows < 5e-3
    assert torch.equal(got, op.render_level_T(packed, pts_T, views_T, z_row,
                                              dn_row, **kw))
    raw = v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV, "bfloat16")
    rgb, depth, acc, w, _ = op._composite_fwd(
        raw.reshape(4, n_rays, seg), z, d.norm(dim=-1), True)
    comp = op._out_rows(rgb, depth, acc, w, seg)
    heads = ((got[3:] - comp[3:]).abs().amax(1)
             / comp[3:].abs().amax(1).clamp_min(1e-30)).max().item()
    print(f"render walk S={seg} rays={n_rays}: rows {rows:.3e}, "
          f"composited #1 heads {heads:.3e}")
    assert heads < 1e-5


def _pdf_problem(n, s_c, dev, seed=0, zero=False):
    g = torch.Generator().manual_seed(seed)
    z = torch.linspace(2.0, 6.0, s_c)
    z_c = torch.sort(z + torch.rand(n, s_c, generator=g) * 4.0 / s_c * 0.9,
                     -1).values
    w = (torch.zeros(n, s_c - 2) if zero
         else torch.rand(n, s_c - 2, generator=g) ** 2)
    return z_c.to(dev), w.to(dev), g


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["det", "sorted"])
@pytest.mark.parametrize("zero", [False, True])
def test_pdf_merge_kernel_matches_plain(cuda_device, draws, zero):
    """#8 on 1001 rays of 64 + 128 samples: exactly sorted, z_c present
    exactly, within 1e-4 of (far - near) of the plain version at the
    99.9th percentile and one coarse bin at most; bit-identical again."""
    n, s_c, s_i, dev = 1001, 64, 128, cuda_device
    z_c, w, g = _pdf_problem(n, s_c, dev, zero=zero)
    u = (pdf_merge.fine_z_draws(None, n, s_i, True, dev).contiguous()
         if draws == "det" else pdf_merge.sorted_uniform(
             torch.rand(n, s_i + 1, generator=g).to(dev)).contiguous())
    before = pdf_merge.launches
    merged, z_s = pdf_merge.sample_pdf_merged(z_c, w, u)
    torch.cuda.synchronize()
    assert pdf_merge.launches == before + 1
    want, want_s = pdf_merge.plain_sample_pdf_merged(z_c, w, u)
    assert torch.all(merged[:, 1:] >= merged[:, :-1])
    assert all(torch.isin(z_c[r], merged[r]).all() for r in range(0, n, 97))
    err = (merged - want).abs() / 4.0
    print(f"pdf_merge {draws} zero={zero}: max {err.max().item():.3e}")
    assert torch.quantile(err.flatten()[:1_000_000], 0.999).item() <= 1e-4
    assert err.max().item() * 4.0 <= 4.0 / (s_c - 1)
    again = pdf_merge.sample_pdf_merged(z_c, w, u)
    assert torch.equal(merged, again[0]) and torch.equal(z_s, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("jitter", [None, "single", "full"])
def test_mip_resample_kernel_matches_plain(cuda_device, jitter):
    """#9 on 1001 rays of 96 samples: within 1e-4 of (far - near) at the
    99.9th percentile and one bin at most; bit-identical again."""
    n, s, dev = 1001, 96, cuda_device
    g = torch.Generator().manual_seed(1)
    t = torch.sort(torch.rand(n, s + 1, generator=g) * 4 + 2,
                   -1).values.to(dev)
    w = (torch.rand(n, s, generator=g) ** 2).to(dev)
    j = None
    if jitter is not None:
        d = 1 if jitter == "single" else s + 1
        j = (torch.rand(n, d, generator=g) * (1 / (s + 1) - 1.2e-7)).to(dev)
    from consistentnerf_tpu_torch.core import sampling

    u = sampling.piecewise_pdf_draws(j, (n,), s + 1, dev).contiguous()
    before = pdf_merge.mip_launches
    got = pdf_merge.mip_resample_t_vals(t, w, u, 0.01)
    torch.cuda.synchronize()
    assert pdf_merge.mip_launches == before + 1
    want = pdf_merge.plain_mip_resample_t_vals(t, w, u, 0.01)
    err = (got - want).abs() / 4.0
    print(f"mip_resample jitter={jitter}: max {err.max().item():.3e}")
    assert torch.quantile(err.flatten(), 0.999).item() <= 1e-4
    assert err.max().item() * 4.0 <= 4.0 / s
    assert torch.equal(got, pdf_merge.mip_resample_t_vals(t, w, u, 0.01))


@pytest.mark.cuda
def test_switched_renders_go_through_the_kernels(cuda_device):
    """The vanilla render with use_onepass_render and use_pdf_kernel (#4
    twice and #8 once per chunk, #1 never) and the mip render with
    use_pdf_kernel and normals (6n twice and #9 once per chunk) agree
    with the plain renders."""
    g = torch.Generator().manual_seed(2)
    n = 600
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    ones = torch.ones(n, 1)
    rays = Rays(origins=-4 * d, directions=d, viewdirs=d,
                radii=ones * 2e-3, lossmult=ones, near=ones * 2,
                far=ones * 6).map(lambda x: x.to(cuda_device).contiguous())
    cfg = configs.Config(netwidth=64, N_samples=32, N_importance=64,
                         white_bkgd=True, compute_dtype="bfloat16",
                         render_chunk_size=256, use_fused_render=True,
                         use_onepass_render=True, use_pdf_kernel=True)
    model = make_model(cfg, cuda_device).eval()
    v2.launches = op.render_launches = pdf_merge.launches = 0
    fused = render_lib.build_render_fn(model, cfg)(rays)
    torch.cuda.synchronize()
    assert (v2.launches, op.render_launches, pdf_merge.launches) == (0, 6, 3)
    plain = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(rays)
    assert (fused["rgb"] - plain["rgb"]).abs().mean().item() < 2e-3
    mcfg = configs.Config(backbone="mipnerf", netwidth=64,
                          mip_num_samples=16, white_bkgd=True,
                          compute_dtype="bfloat16", render_chunk_size=256,
                          use_fused_render=True, use_pdf_kernel=True,
                          disable_normals=False)
    mmodel = make_model(mcfg, cuda_device).eval()
    fmip.launches = fmip.normals_launches = pdf_merge.mip_launches = 0
    fused = render_lib.build_render_fn(mmodel, mcfg)(rays)
    torch.cuda.synchronize()
    assert (fmip.launches, fmip.normals_launches,
            pdf_merge.mip_launches) == (0, 6, 3)
    plain = render_lib.build_render_fn(
        mmodel, mcfg.replace(use_fused_render=False))(rays)
    for k in ("rgb", "normals"):
        assert (fused[k] - plain[k]).abs().mean().item() < 2e-3, k


# ------------------- the row-major kernels #10, #11, #15, #16 -------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_kernels_match_plain_and_transposed(cuda_device, dtype):
    """#10 and #11 ([N, 3] streams) against their plain versions, and
    against #1 and #2 on the same points (n = 3000: ragged tiles and
    chunks): #10 and #1 give the same bits, and so do #11 and #2 (the
    same walk in each dtype: in bf16 the level walk, whose row-major
    staging changes no value and no sum order)."""
    flat = _mlp_flat(256, cuda_device)
    n = 3000
    pts_T, views_T = _inputs(n, cuda_device)
    pts, views = pts_T.T.contiguous(), views_T.T.contiguous()
    g = torch.randn(n, 4, generator=torch.Generator().manual_seed(3)).to(
        cuda_device)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, dtype)
    before = (v2.row_launches, v2.row_bwd_launches)
    got = v2.fwd(packed, pts, views, 8, SKIPS, MR, MV, dtype)
    grads = v2.bwd(packed, pts, views, g, 8, SKIPS, MR, MV, dtype)
    torch.cuda.synchronize()
    assert (v2.row_launches, v2.row_bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = v2.plain_fwd_row(packed, pts, views, 8, SKIPS, MR, MV, dtype)
    assert got.shape == (n, 4) and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[dtype]
    walk = v2.packed_bwd_reference_T(packed, pts_T, views_T,
                                     g.T.contiguous())
    assert _rel(grads, walk) < TRAIN_TOL[dtype]
    assert torch.equal(got, v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR,
                                     MV, dtype).T)
    grads_T = v2.bwd_T(packed, pts_T, views_T, g.T.contiguous(), 8, SKIPS,
                       MR, MV, dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_T))


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED_BWD_N)
@pytest.mark.parametrize("kernel", ["v2row", "v1"])
def test_row_bwd_kernels_at_ragged_sizes(cuda_device, kernel, n):
    """#11 and #14 in bf16 at 8x256 (the level walk in mode 2 on row-major
    streams) at the ragged sizes of #2: within the tolerance of the packed
    walk, a second launch bit-identical to the first, #11 bit-identical to
    #2 on the transposed points and #14 to #11 (at this shape v1's heads
    read h alone, so the offsets are #11's)."""
    flat = _mlp_flat(256, cuda_device)
    pts_T, views_T = _inputs(n, cuda_device, seed=n)
    pts, views = pts_T.T.contiguous(), views_T.T.contiguous()
    g = torch.randn(n, 4, generator=torch.Generator().manual_seed(5)).to(
        cuda_device)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, "bfloat16")

    def run():
        if kernel == "v2row":
            return v2.bwd(packed, pts, views, g, 8, SKIPS, MR, MV,
                          "bfloat16")
        return fmt.backward(fm.pack_v1(flat, 8, SKIPS, MR, MV, "bfloat16"),
                            pts, views, g, 8, SKIPS, MR, MV, "bfloat16")
    got = run()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    want = v2.packed_bwd_reference_T(packed, pts_T, views_T,
                                     g.T.contiguous())
    assert _rel(got, want) < TRAIN_TOL["bfloat16"]
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    twin = (v2.bwd_T(packed, pts_T, views_T, g.T.contiguous(), 8, SKIPS,
                     MR, MV, "bfloat16") if kernel == "v2row" else
            v2.bwd(packed, pts, views, g, 8, SKIPS, MR, MV, "bfloat16"))
    assert all(torch.equal(a, b) for a, b in zip(got, twin))


@pytest.mark.cuda
def test_row_bwd_plans_pick_the_level_walk(cuda_device):
    """The bf16 plans of #11 and #14 run the level walk at the two-call
    step's levels (983,040 and 327,680 points) with #2's grid and chunks
    and the row-major staging's 9 x 64 floats more shared memory; #14's
    also at a depth-5 skip into the heads and at multires 21; fp32 keeps
    train_block."""
    import ctypes

    def plan(symbol, lib, n, depth=8, mr=MR, bf16=1):
        out = (ctypes.c_longlong * 9)()
        fn = v2._entry(lib, symbol + "_plan", 0, 7)
        assert fn(n, depth, 256, 1 << SKIPS[0], mr, MV, bf16, out) == 0
        return list(out)
    for n in (983_040, 327_680):
        p2 = plan(v2.BWD_KERNEL, v2.BWD_KERNEL, n)
        for symbol, lib in ((v2.ROW_BWD_KERNEL, v2.BWD_KERNEL),
                            (fmt.BWD_KERNEL, fmt.BWD_KERNEL)):
            p = plan(symbol, lib, n)
            assert p[8] == 1
            assert p[3] == p2[3] + 9 * 64 * 4
            assert p[:3] + p[4:] == p2[:3] + p2[4:]
            assert plan(symbol, lib, n, bf16=0)[8] == 0
    for depth, mr in ((5, MR), (8, 21)):
        p = plan(fmt.BWD_KERNEL, fmt.BWD_KERNEL, 100_003, depth, mr)
        assert p[8] == 1
        packed = fm.pack_v1(
            _v1_flat(depth, SKIPS, mr, MV, True, cuda_device), depth, SKIPS,
            mr, MV, "bfloat16")
        assert p[3] == fm.walk_smem_bytes(packed, -(-p[4] // 64) * 64)


@pytest.mark.cuda
def test_mip_row_bwd_plan_picks_the_level_walk(cuda_device):
    """#16's bf16 plan runs the level walk at the mip level (393,216
    points) and at a ragged size with #7's grid and chunks and the
    row-major staging's 9 x 64 floats more shared memory; fp32 keeps
    train_block (slot 8 is 0)."""
    import ctypes

    cfg = fmip._cfg_args(fmip.pack(_mip_flat(256, cuda_device), 8, 16,
                                   "bfloat16"))[:-1]

    def plan(symbol, n, bf16=1):
        out = (ctypes.c_longlong * 9)()
        fn = v2._entry(fmip.BWD_KERNEL, symbol + "_plan", 0, 8)
        assert fn(n, *cfg, bf16, out) == 0
        return list(out)
    for n in (393_216, 1_001):
        p7 = plan(fmip.BWD_KERNEL, n)
        p = plan(fmip.ROW_BWD_KERNEL, n)
        assert p7[8] == p[8] == 1
        assert p[3] == p7[3] + 9 * 64 * 4
        assert p[:3] + p[4:] == p7[:3] + p7[4:]
        assert plan(fmip.ROW_BWD_KERNEL, n, bf16=0)[8] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mip_row_kernels_match_plain_and_transposed(cuda_device, dtype):
    """#15 and #16 against their plain versions and against #6 and #7 on
    the same points, bit for bit in both types (one walk under two
    layouts: in bf16 the Hopper forward walk and the level walk); a bf16
    repeat gives the first launch's bits; the op fused_mip_mlp_train
    launches each once."""
    flat = _mip_flat(256, cuda_device)
    n = 3000
    streams_T = _mip_inputs(n, cuda_device)
    means, covs, views = (x.T.contiguous() for x in streams_T)
    g = 1e-2 * torch.randn(n, 4, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda_device)
    packed = fmip.pack(flat, 8, 16, dtype)
    got = fmip.fwd(packed, means, covs, views, 8, 16, dtype)
    want = fmip.plain_fwd_row(packed, means, covs, views, 8, 16, dtype)
    assert got.shape == (n, 4) and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[dtype]
    assert torch.equal(got, fmip.fwd_T(packed, *streams_T, 8, 16, dtype).T)
    grads = fmip.bwd(packed, means, covs, views, g, 8, 16, dtype)
    plain = fmip.plain_bwd_row(packed, means, covs, views, g, 8, 16, dtype)
    assert _rel(grads, plain) < PLAIN_DW_TOL[dtype]
    grads_T = fmip.bwd_T(packed, *streams_T, g.T.contiguous(), 8, 16, dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_T))
    if dtype == "bfloat16":
        assert torch.equal(got, fmip.fwd(packed, means, covs, views, 8, 16,
                                         dtype))
        again = fmip.bwd(packed, means, covs, views, g, 8, 16, dtype)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
    before = (fmip.row_launches, fmip.row_bwd_launches)
    leaves = [w.clone().requires_grad_() for w in flat]
    raw = fmip.fused_mip_mlp_train(leaves, means, covs, views, 8, 16, dtype)
    (raw * g).sum().backward()
    torch.cuda.synchronize()
    assert (fmip.row_launches, fmip.row_bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert all(torch.equal(w.grad, a) for w, a in zip(leaves, grads))


@pytest.mark.cuda
def test_twocall_steps_go_through_their_kernels(cuda_device):
    """One two-call step per fused_kernel at a small config launches the
    kernels of its kind: v2 #1/#2, v2row #10/#11, v2h #11 only."""
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.train import loop

    scene = synthetic.make_scene(n_views=4, H=32, W=32).to_scene_data()
    for kind, want in (("v2", (2, 2, 0, 0)), ("v2row", (0, 0, 2, 2)),
                       ("v2h", (0, 0, 0, 2))):
        cfg = configs.Config(netdepth=8, netwidth=64, N_samples=16,
                             N_importance=16, N_rand=256, n_patches=1,
                             patch_size=8, softLpmask=True,
                             with_depth_loss=True, white_bkgd=True,
                             compute_dtype="bfloat16", use_fused_train=True,
                             use_onepass_train=True, fused_kernel=kind)
        state = loop.init_state(cfg, cuda_device)
        batch = to_device(VanillaBatcher(scene, cfg).next_batch(),
                          cuda_device)
        step = loop.select_train_step(cfg, state.model)
        v2.launches = v2.bwd_launches = 0
        v2.row_launches = v2.row_bwd_launches = 0
        _, stats = step(state, batch)
        torch.cuda.synchronize()
        assert (v2.launches, v2.bwd_launches, v2.row_launches,
                v2.row_bwd_launches) == want, kind
        assert torch.isfinite(stats["loss"])


# --------------------------- the v1 kernels #12-#14 -----------------------

from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt  # noqa: E402

# (depth, skips, multires, multires_views, use_viewdirs): the production
# MLP, a skip into the heads, multires 21, and the output head (#12 only).
V1_SHAPES = {"depth8": (8, (4,), 10, 4, True),
             "skip_heads": (5, (4,), 10, 4, True),
             "multires21": (8, (4,), 21, 4, True),
             "output_head": (5, (4,), 10, 4, False)}


def _v1_flat(depth, skips, mr, mv, use_viewdirs, device, width=256):
    mlp = NeRFMLP(net_depth=depth, net_width=width,
                  input_ch=3 * (1 + 2 * mr), input_ch_views=3 * (1 + 2 * mv),
                  skips=skips, use_viewdirs=use_viewdirs, output_ch=5)
    mlp.reset_parameters(torch.Generator().manual_seed(2))
    return [w.detach().to(device)
            for w in fm.flatten_params(mlp, use_viewdirs, depth)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(V1_SHAPES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_v1_kernels_match_plain(cuda_device, shape, dtype):
    """#12 / #13 (one launch each) against the plain forward, #14 against
    the v1 packing's backward walk and bit-identical across two runs
    (n = 3000: ragged tiles and chunks)."""
    depth, skips, mr, mv, uv = V1_SHAPES[shape]
    flat = _v1_flat(depth, skips, mr, mv, uv, cuda_device)
    n = 3000
    pts_T, views_T = _inputs(n, cuda_device)
    pts, views = pts_T.T.contiguous(), views_T.T.contiguous()
    kw = dict(net_depth=depth, skips=skips, multires=mr, multires_views=mv)
    packed = fm.pack_v1(flat, depth, skips, mr, mv, dtype, use_viewdirs=uv)
    before = (fm.launches, fmt.fwd_launches, fmt.bwd_launches)
    got = fm.fused_mlp(packed, pts, views, use_viewdirs=uv,
                       compute_dtype=dtype, **kw)
    torch.cuda.synchronize()
    want = fm._mlp_body(pts, views, flat, use_viewdirs=uv,
                        compute_dtype=dtype, **kw)
    assert got.shape == (n, 4 if uv else 5) and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[dtype]
    assert fm.launches == before[0] + 1
    if not uv:
        return
    got13 = fmt.forward(packed, pts, views, compute_dtype=dtype, **kw)
    assert torch.equal(got13, got)
    g = torch.randn(n, 4, generator=torch.Generator().manual_seed(3)).to(
        cuda_device)
    grads = fmt.backward(packed, pts, views, g, compute_dtype=dtype, **kw)
    again = fmt.backward(packed, pts, views, g, compute_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    walk = v2.packed_bwd_reference_T(packed, pts_T, views_T,
                                     g.T.contiguous())
    assert _rel(grads, walk) < TRAIN_TOL[dtype]
    assert (fmt.fwd_launches, fmt.bwd_launches) == (before[1] + 1,
                                                    before[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 198 * 128 - 50])
def test_v1_forward_runs_10s_walk_at_its_shapes(cuda_device, n):
    """At 8x256 / multires 10+4 in bf16, #12 and #13 plan and run #10's
    instance of the Hopper walk: #10's plan, #10's bits on the same points
    (and #1's, transposed), and a repeat's bits; fp32 keeps mlp_fwd.cuh's
    walk."""
    flat = _v1_flat(*V1_SHAPES["depth8"], cuda_device)
    kw = dict(net_depth=8, skips=(4,), multires=10, multires_views=4)
    packed1 = fm.pack_v1(flat, compute_dtype="bfloat16", **kw)
    packed = v2.pack(flat, compute_dtype="bfloat16", **kw)
    assert fm.fwd_plan(packed1, n) == v2.fwd_plan(packed, n, row=True)
    assert fm.fwd_plan(packed1, n)["hopper"] == 1
    assert fm.fwd_plan(fm.pack_v1(flat, compute_dtype="float32", **kw),
                       n)["hopper"] == 0
    pts_T, views_T = _inputs(n, cuda_device)
    pts, views = pts_T.T.contiguous(), views_T.T.contiguous()
    r10 = v2.fwd(packed, pts, views, compute_dtype="bfloat16", **kw)
    r12 = fm.fused_mlp(packed1, pts, views, compute_dtype="bfloat16", **kw)
    r13 = fmt.forward(packed1, pts, views, compute_dtype="bfloat16", **kw)
    again = fm.fused_mlp(packed1, pts, views, compute_dtype="bfloat16", **kw)
    r1 = v2.fwd_T(packed, pts_T, views_T, compute_dtype="bfloat16", **kw)
    torch.cuda.synchronize()
    assert torch.equal(r12, r10) and torch.equal(r13, r10)
    assert torch.equal(again, r12) and torch.equal(r10, r1.T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["skip_heads", "multires21",
                                   "output_head"])
def test_v1_forward_plan_keeps_the_old_walk_past_1s_shapes(cuda_device,
                                                           shape):
    """A skip into the heads, P = 144 at multires 21 and the output head
    are shapes the Hopper walk does not take: #12's plan keeps
    mlp_fwd.cuh's walk there in bf16, with its shared memory."""
    depth, skips, mr, mv, uv = V1_SHAPES[shape]
    packed = fm.pack_v1(_v1_flat(depth, skips, mr, mv, uv, cuda_device),
                        depth, skips, mr, mv, "bfloat16", use_viewdirs=uv)
    plan = fm.fwd_plan(packed, 3000)
    assert plan["hopper"] == 0 and plan["tile"] == 128
    assert plan["smem_bytes"] == fm.v1_smem_bytes(packed)[0]


@pytest.mark.cuda
def test_v1_routes_go_through_their_kernels(cuda_device):
    """One two-call step of each v1 kind (v1: #13 and #14 per level;
    hybrid: #14 only) and the v1 render (#12 per level and chunk)."""
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.train import evaluation, loop

    scene = synthetic.make_scene(n_views=4, H=32, W=32).to_scene_data()
    for kind, want in (("v1", (0, 2, 2)), ("hybrid", (0, 0, 2))):
        cfg = configs.Config(netdepth=8, netwidth=64, N_samples=16,
                             N_importance=16, N_rand=256, n_patches=1,
                             patch_size=8, softLpmask=True,
                             with_depth_loss=True, white_bkgd=True,
                             compute_dtype="bfloat16", use_fused_train=True,
                             use_onepass_train=True, fused_kernel=kind)
        state = loop.init_state(cfg, cuda_device)
        batch = to_device(VanillaBatcher(scene, cfg).next_batch(),
                          cuda_device)
        step = loop.select_train_step(cfg, state.model)
        fm.launches = fmt.fwd_launches = fmt.bwd_launches = 0
        _, stats = step(state, batch)
        torch.cuda.synchronize()
        assert (fm.launches, fmt.fwd_launches, fmt.bwd_launches) == want
        assert torch.isfinite(stats["loss"])
    cfg = configs.Config(netdepth=8, netwidth=64, N_samples=16,
                         N_importance=16, white_bkgd=True,
                         compute_dtype="bfloat16", use_fused_render=True,
                         fused_kernel="v1", render_chunk_size=512)
    model = make_model(cfg, cuda_device).eval()
    rays = evaluation.camera_rays_for_view(scene, scene.poses[0],
                                           device=cuda_device)
    fm.launches = 0
    out = render_lib.build_render_fn(model, cfg)(rays)
    torch.cuda.synchronize()
    assert fm.launches == 2 * (32 * 32 // 512)
    plain = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(rays)
    assert (out["rgb"] - plain["rgb"]).abs().mean().item() < 2e-3


@pytest.mark.cuda
def test_hard_masks_on_the_card_match_the_cpu(cuda_device):
    """compute_hard_masks on the card against the same function on CPU
    tensors: identical but for pixels of the boundary rule."""
    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.data import synthetic

    for layout in ("sphere", "cluster"):
        s = synthetic.make_scene(n_views=6, H=64, W=64,
                                 layout=layout).to_scene_data()
        args = (s.poses, s.depths, s.K, s.i_train, s.H, s.W)
        got = reproject.compute_hard_masks(*args, device=cuda_device)
        want = reproject.compute_hard_masks(*args, device="cpu")
        near = reproject.boundary_pixels(*args, device="cpu")
        diff = got != want
        assert not (diff & ~near).any(), layout
        assert diff.sum() <= 1e-4 * len(s.i_train) * s.H * s.W
        assert 0.1 < got[s.i_train].mean() < 0.6


# ------------------- the Hopper walk of #1 and #6 (fwd_hopper.cuh) --------


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 127, 129])
def test_hopper_walk_matches_plain_at_ragged_sizes(cuda_device, width, n):
    """#1 in bf16 runs the Hopper walk at widths 64-256: against its plain
    version at ragged sizes, and bit for bit against its row-major twin
    #10, the same walk under the row-major layout."""
    flat = _mlp_flat(width, cuda_device)
    pts_T, views_T = _inputs(n, cuda_device)
    packed = v2.pack(flat, 8, SKIPS, MR, MV, "bfloat16")
    assert v2.fwd_plan(packed, n)["hopper"] == 1
    got = v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV, "bfloat16")
    want = v2.plain_fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV,
                          "bfloat16")
    assert got.shape == (4, n) and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[
        "bfloat16"]
    twin = v2.fwd(packed, pts_T.T.contiguous(), views_T.T.contiguous(), 8,
                  SKIPS, MR, MV, "bfloat16")
    assert torch.equal(got, twin.T)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("n", [1, 127, 129])
def test_hopper_mip_walk_matches_plain_at_ragged_sizes(cuda_device, width,
                                                       n):
    """#6 in bf16 on the Hopper walk, at width 64 too (its 128-wide view
    layer is wider than the trunk): against its plain version and bit for
    bit against its row-major twin #15."""
    flat = _mip_flat(width, cuda_device)
    means, covs, views = _mip_inputs(n, cuda_device)
    packed = fmip.pack(flat, 8, 16, "bfloat16")
    assert fmip.fwd_plan(packed, n)["hopper"] == 1
    got = fmip.fwd_T(packed, means, covs, views, 8, 16, "bfloat16")
    want = fmip.plain_fwd_T(packed, means, covs, views, 8, 16, "bfloat16")
    assert got.shape == (4, n) and torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().mean()).item() < TOL[
        "bfloat16"]
    twin = fmip.fwd(packed, means.T.contiguous(), covs.T.contiguous(),
                    views.T.contiguous(), 8, 16, "bfloat16")
    assert torch.equal(got, twin.T)


@pytest.mark.cuda
def test_hopper_walks_repeat_bit_for_bit(cuda_device):
    """A second launch of #1 and of #6 gives the first one's bits, over
    more tiles than the grid has blocks (the persistent loop)."""
    n = 198 * 128 - 50
    packed = v2.pack(_mlp_flat(256, cuda_device), 8, SKIPS, MR, MV,
                     "bfloat16")
    pts_T, views_T = _inputs(n, cuda_device)
    first = v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR, MV, "bfloat16")
    assert torch.equal(first, v2.fwd_T(packed, pts_T, views_T, 8, SKIPS, MR,
                                       MV, "bfloat16"))
    mpacked = fmip.pack(_mip_flat(256, cuda_device), 8, 16, "bfloat16")
    streams = _mip_inputs(n, cuda_device)
    first = fmip.fwd_T(mpacked, *streams, 8, 16, "bfloat16")
    assert torch.equal(first, fmip.fwd_T(mpacked, *streams, 8, 16,
                                         "bfloat16"))


@pytest.mark.cuda
def test_fwd_plans_pick_the_walk_by_shape(cuda_device):
    """The plans take the Hopper walk at the flagship shapes, for #1 and
    #6 and their row-major twins #10 and #15 alike, and mlp_fwd.cuh's
    walk in fp32 and at width 32."""
    n = 8192 * 192
    flat = _mlp_flat(256, cuda_device)
    bf = v2.pack(flat, 8, SKIPS, MR, MV, "bfloat16")
    plan = v2.fwd_plan(bf, n)
    assert plan["hopper"] == 1 and plan["tile"] == 128
    assert plan["blocks"] == min(torch.cuda.get_device_properties(
        cuda_device).multi_processor_count, plan["tiles"])
    assert plan["tiles"] == n // 128 and plan["stages"] >= 2
    assert v2.fwd_plan(v2.pack(flat, 8, SKIPS, MR, MV, "float32"),
                       n)["hopper"] == 0
    assert v2.fwd_plan(v2.pack(_mlp_flat(32, cuda_device), 8, SKIPS, MR, MV,
                               "bfloat16"), n)["hopper"] == 0
    assert v2.fwd_plan(bf, n, row=True) == plan
    mflat = _mip_flat(256, cuda_device)
    mbf = fmip.pack(mflat, 8, 16, "bfloat16")
    assert fmip.fwd_plan(mbf, 8192 * 96)["hopper"] == 1
    assert fmip.fwd_plan(fmip.pack(mflat, 8, 16, "float32"),
                         8192 * 96)["hopper"] == 0
    assert fmip.fwd_plan(mbf, 8192 * 96, row=True) == fmip.fwd_plan(
        mbf, 8192 * 96)


@pytest.mark.cuda
def test_hopper_walk_refuses_misaligned_weights(cuda_device):
    """The walk reads the packed weights by TMA, which needs a 16-byte
    aligned base: the wrappers of #1 and #6 raise on one that is not."""
    import dataclasses

    def shifted(packed):
        buf = torch.empty(packed.w.numel() + 1, dtype=packed.w.dtype,
                          device=packed.w.device)
        buf[1:].copy_(packed.w)
        return dataclasses.replace(packed, w=buf[1:])

    pts_T, views_T = _inputs(300, cuda_device)
    bad = shifted(v2.pack(_mlp_flat(256, cuda_device), 8, SKIPS, MR, MV,
                          "bfloat16"))
    assert bad.w.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        v2.fwd_T(bad, pts_T, views_T, 8, SKIPS, MR, MV, "bfloat16")
    mbad = shifted(fmip.pack(_mip_flat(256, cuda_device), 8, 16,
                             "bfloat16"))
    with pytest.raises(ValueError, match="aligned"):
        fmip.fwd_T(mbad, *_mip_inputs(300, cuda_device), 8, 16, "bfloat16")
    with pytest.raises(ValueError, match="aligned"):
        fmip.fwd(mbad, *(x.T.contiguous() for x in _mip_inputs(
            300, cuda_device)), 8, 16, "bfloat16")
