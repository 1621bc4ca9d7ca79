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
bit for bit against #2 and #14 against #11 on the same points (and #2,
#3 and #11 in fp32 on the walk's fp32 path: plans, ragged sizes and
rays, repeats, #11 against #2), the
evaluation's metric suite and `evaluate()` on the card against the CPU,
the one-pass step with ss_loss (#3 on the reference rays) against
its packed walk and the eager step, the depth-prior producers' quality
runs (the supervised MVS net against baselines, the warmup bootstrap end
to end with a consistent retrain), and the whole trainer: the one-pass
step with the train-time LPIPS term against the eager step, the term,
the noisy eager step and the mip eager step with normals against the
CPU, train() with its housekeeping and a checkpoint exported and
imported back, and a mip checkpoint imported from a flax msgpack file
rendered through #6.

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
from torch_port_shared import _one_torch_thread  # noqa: F401

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
    width 320; in fp32 both take the fp32 level walk;
    and on a 132-SM card they give the one-pass steps' patch launches
    full waves: no block walks more rows than the launch's points spread
    evenly over the grid need."""
    for kernel in ("mlp", "mip"):
        for width in (64, 256):
            assert _bwd_plan(kernel, 196_608, width)[8] == 1
        assert _bwd_plan(kernel, 3000, 320)[8] == 0
        assert _bwd_plan(kernel, 3000, 256, bf16=0)[8] == 1
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
    out2, dw2 = op.onepass_level(packed, *args, white_bkgd=True,
                                 compute_dtype=dtype)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw2))


def _level_plan(n_rays, seg, width, bf16=1):
    import ctypes

    out = (ctypes.c_longlong * 9)()
    assert op._kernel()[0](n_rays, seg, 8, width, 16, MR, MV, bf16,
                           out) == 0
    return list(out)


@pytest.mark.cuda
def test_fp32_plans_pick_the_level_walk(cuda_device):
    """In fp32 the plans of #3 at the vanilla presets' random rays (4096
    rays of 192 and 64 samples), #2 at their patch rays (196,608 and
    65,536 points) and #11 take the fp32 level walk (slot 8) with the bf16
    plan's grid and chunks, three workspace planes and the fp32 walk's
    shared memory (fp32 tiles, one activation tile; #11 with the
    row-major staging); width 320 keeps train_block in fp32 too."""
    import ctypes

    packed = v2.pack(_mlp_flat(256, cuda_device), 8, SKIPS, MR, MV,
                     "float32")

    def row_plan(n, bf16):
        out = (ctypes.c_longlong * 9)()
        fn = v2._entry(v2.BWD_KERNEL, v2.ROW_BWD_KERNEL + "_plan", 0, 7)
        assert fn(n, 8, 256, 1 << SKIPS[0], MR, MV, bf16, out) == 0
        return list(out)
    pairs = [(_level_plan(4096, s, 256, 0), _level_plan(4096, s, 256), False)
             for s in (192, 64)]
    pairs += [(_bwd_plan("mlp", n, 256, 0), _bwd_plan("mlp", n, 256), False)
              for n in (196_608, 65_536)]
    pairs += [(row_plan(196_608, 0), row_plan(196_608, 1), True)]
    for p32, p16, row in pairs:
        assert p32[8] == 1
        assert p32[0] == p16[0] and p32[2] == p16[2] and p32[4] == p16[4]
        assert p32[1] == 3 * p16[1]
        assert p32[3] == fm.walk_smem_bytes(packed, -(-p32[4] // 64) * 64,
                                            row)
        assert p32[3] + fm.K_WALK_STATIC <= fm.SMEM_LIMIT
        # The fp32 dW GEMM takes 32-point slabs.
        rows = p32[1] // (3 * sum(_ws_cols(packed)))
        assert p32[5] * p32[7] >= rows // 32 > (p32[5] - 1) * p32[7]
    assert _bwd_plan("mlp", 3000, 320, 0)[8] == 0
    assert _level_plan(37, 24, 320, 0)[8] == 0
    # The mip kernels at the mip presets' shapes (#5 at 1024 x 96, #7 at
    # the patch rays and the TV norm's random-pose rays, #16): the fp32
    # walk, its pe tile in the weight ring.
    mpk = fmip.pack(_mip_flat(256, cuda_device), 8, 16, "float32")
    mcfg = fmip._cfg_args(mpk)[:-1]

    def mip_plan(symbol, lead, bf16):
        out = (ctypes.c_longlong * 9)()
        lib = op.MIP_KERNEL if symbol == op.MIP_KERNEL else fmip.BWD_KERNEL
        fn = v2._entry(lib, symbol + "_plan", 0, len(lead) + 7)
        assert fn(*lead, *mcfg, bf16, out) == 0
        return list(out)
    for symbol, lead, row in ((op.MIP_KERNEL, (1024, 96), False),
                              (fmip.BWD_KERNEL, (98_304,), False),
                              (fmip.BWD_KERNEL, (196_608,), False),
                              (fmip.ROW_BWD_KERNEL, (98_304,), True)):
        p32, p16 = mip_plan(symbol, lead, 0), mip_plan(symbol, lead, 1)
        assert p32[8] == 1
        assert p32[0] == p16[0] and p32[2] == p16[2] and p32[4] == p16[4]
        assert p32[1] == 3 * p16[1]
        assert p32[3] == fm.walk_smem_bytes(mpk, -(-p32[4] // 64) * 64, row)
        assert p32[3] + fm.K_WALK_STATIC <= fm.SMEM_LIMIT


def _ws_cols(packed):
    """The level walk's workspace columns a point (level_train.cuh::Cols):
    pe, ve, every activation, feature, the view layer's output, and their
    gradients."""
    p, v = (v2._pad16(x) for x in v2.enc_widths(
        packed.encoder, packed.multires, packed.multires_views))
    w, h = packed.width, packed.view_width
    return (p, v, 2 * (packed.net_depth * w + w + h))


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED_BWD_N)
def test_fp32_walk_at_ragged_sizes(cuda_device, n):
    """#2 and #11 in fp32 at 8x256 on the fp32 level walk (six bf16
    products a fp32 product) against the packed walk in fp32 (the card's
    fp32 matmul) at the ragged sizes of #2: within TRAIN_TOL, a second
    launch bit-identical to the first, and #11 bit-identical to #2 on the
    same points."""
    packed = v2.pack(_mlp_flat(256, cuda_device), 8, SKIPS, MR, MV,
                     "float32")
    pts_T, views_T = _inputs(n, cuda_device, seed=n)
    g = torch.randn(4, n, generator=torch.Generator().manual_seed(5)).to(
        cuda_device)

    def run():
        return v2.bwd_T(packed, pts_T, views_T, g, 8, SKIPS, MR, MV,
                        "float32")
    got = run()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    want = v2.packed_bwd_reference_T(packed, pts_T, views_T, g)
    print(f"fp32 bwd N={n}: rel {_rel(got, want):.3e}")
    assert _rel(got, want) < TRAIN_TOL["float32"]
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    row = v2.bwd(packed, pts_T.T.contiguous(), views_T.T.contiguous(),
                 g.T.contiguous(), 8, SKIPS, MR, MV, "float32")
    assert all(torch.equal(a, b) for a, b in zip(got, row))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 3, 395])
@pytest.mark.parametrize("seg", [64, 192])
def test_fp32_onepass_at_ragged_rays(cuda_device, seg, n_rays):
    """#3 in fp32 at 8x256 on the fp32 level walk at 1, 3 and 395 rays
    (one ray, a chunk's ragged sub-tile, several chunks with a ragged
    last one) against the packed walk in fp32: rows within 1e-4 of a
    row's max, dW within TRAIN_TOL, a repeat bit-identical."""
    flat = _mlp_flat(256, cuda_device, seed=2)
    g = torch.Generator().manual_seed(n_rays)
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
    packed = v2.pack(flat, 8, SKIPS, MR, MV, "float32")
    out, dw = op.onepass_level(packed, *args, white_bkgd=True,
                               compute_dtype="float32")
    torch.cuda.synchronize()
    want_out, want_dw = op.packed_onepass_reference(packed, *args, True)
    assert torch.isfinite(out).all()
    rows_rel = ((out - want_out).abs().amax(1)
                / want_out.abs().amax(1).clamp_min(1e-30)).max().item()
    print(f"fp32 onepass S={seg} rays={n_rays}: rows {rows_rel:.3e}, dW "
          f"rel {_rel(dw, want_dw):.3e}")
    assert rows_rel < 1e-4
    assert _rel(dw, want_dw) < TRAIN_TOL["float32"]
    out2, dw2 = op.onepass_level(packed, *args, white_bkgd=True,
                                 compute_dtype="float32")
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw2))


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


def _pdf_weights(kind, n, k, g):
    """Weights [n, k]: squared uniforms, all zero, one-hot, or so small
    that the 1e-5 floor makes the pdf."""
    if kind == "zero":
        return torch.zeros(n, k)
    if kind == "onehot":
        w = torch.zeros(n, k)
        w[torch.arange(n), torch.randint(0, k, (n,), generator=g)] = 1.0
        return w
    w = torch.rand(n, k, generator=g) ** 2
    return w * 1e-9 if kind == "floor" else w


def _pdf_problem(n, s_c, dev, seed=0, weights="squared"):
    g = torch.Generator().manual_seed(seed)
    z = torch.linspace(2.0, 6.0, s_c)
    z_c = torch.sort(z + torch.rand(n, s_c, generator=g) * 4.0 / s_c * 0.9,
                     -1).values
    return z_c.to(dev), _pdf_weights(weights, n, s_c - 2, g).to(dev), g


def _resample_gates(got, want, span, bins, z_c=None, step=None):
    """The gates of chip_smoke.py's resample_gate: exactly sorted, z_c
    present exactly, within 1e-4 of the span at the 99.9th percentile and
    one bin at most. `step` [n, k], (mask, width): samples on a step of
    the function, held to their own step's width instead."""
    assert torch.all(got[:, 1:] >= got[:, :-1])
    if z_c is not None:
        idx = torch.searchsorted(got, z_c).clamp(max=got.shape[1] - 1)
        assert torch.equal(got.gather(1, idx), z_c)
    err = (got - want).abs() / span
    if step is not None:
        on, width = step
        assert torch.all(err[on] * span <= width[on])
        err = err[~on]
    assert torch.quantile(err.flatten()[:1_000_000], 0.999).item() <= 1e-4
    assert err.max().item() <= 1.0 / bins


def _last_draw_step(z_c, w, u):
    """The draws u = 1 in rows whose last interval's pdf is at the 1e-5
    floor, and the width of the step there: the draw lands on the last
    midpoint where the cdf's last entry rounds to 1 or below, and near the
    midpoint before it where it rounds above 1 (the interval's width
    under 1e-5 counts as 1). Which, the last ulp of the cdf's sums
    decides, so two sum orders (the plain version's, #8's or the TPU
    kernel's) put it on either side. Returns (mask [n, s_i], width
    [n, s_i])."""
    w = w + 1e-5
    last = (w[:, -1] / w.sum(-1)) < 1.01e-5
    mid = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    width = (mid[:, -1] - mid[:, -2])[:, None].expand_as(u)
    return (u == 1.0) & last[:, None], width


@pytest.mark.cuda
@pytest.mark.parametrize("n,s_c,s_i,weights", [
    (1001, 64, 128, "squared"), (1001, 64, 128, "zero"),
    (1001, 64, 128, "onehot"), (1001, 64, 128, "floor"),
    (1, 64, 128, "squared"), (7, 64, 128, "squared"),
    (8193, 64, 128, "squared"), (300, 3, 1, "squared"),
    (300, 128, 128, "squared"), (300, 128, 128, "onehot")])
@pytest.mark.parametrize("draws", ["det", "sorted"])
def test_pdf_merge_kernel_matches_plain(cuda_device, n, s_c, s_i, weights,
                                        draws):
    """#8 at ragged ray counts, the row limits and degenerate weights:
    exactly sorted, z_c present exactly, within 1e-4 of (far - near) of
    the plain version at the 99.9th percentile and one coarse bin at most
    (the samples at the last draw's step, `_last_draw_step`, within that
    step); on views (weights w[:, 1:-1] of a wider row, the expanded
    linspace or a slice of wider draws) bit for bit the contiguous rows'
    result, and bit-identical again."""
    dev = cuda_device
    z_c, w, g = _pdf_problem(n, s_c, dev, weights=weights)
    if draws == "det":
        u_view = pdf_merge.fine_z_draws(None, n, s_i, True, dev)
    else:
        u_view = pdf_merge.sorted_uniform(
            torch.rand(n, s_i + 3, generator=g).to(dev))[:, :s_i]
    w_view = torch.cat([w[:, :1], w, w[:, -1:]], 1)[:, 1:-1]
    u = u_view.contiguous()
    before = pdf_merge.launches
    merged, z_s = pdf_merge.sample_pdf_merged(z_c, w, u)
    torch.cuda.synchronize()
    assert pdf_merge.launches == before + 1
    want, want_s = pdf_merge.plain_sample_pdf_merged(z_c, w, u)
    print(f"pdf_merge {n} x {s_c}+{s_i} {weights} {draws}: max "
          f"{(merged - want).abs().max().item() / 4.0:.3e}")
    _resample_gates(merged, want, 4.0, s_c - 1, z_c)
    step = _last_draw_step(z_c, w, u)
    print(f"  {int(step[0].sum())} samples at the last draw's step")
    _resample_gates(z_s, want_s, 4.0, s_c - 1, step=step)
    assert w_view.stride(0) == s_c and u_view.stride(1) == 1
    views = pdf_merge.sample_pdf_merged(z_c, w_view, u_view)
    assert torch.equal(merged, views[0]) and torch.equal(z_s, views[1])
    again = pdf_merge.sample_pdf_merged(z_c, w, u)
    assert torch.equal(merged, again[0]) and torch.equal(z_s, again[1])


def inversion_problem(n, seed=0):
    """Rows where fp32 rounding puts the first of two samples above the
    second: S_c = 4, draws 1 and the float just below it, midpoints ~0.05,
    ~0.5 and ~1.7 apart in magnitude, so that b_1 + 1 (b_2 - b_1) can
    round above b_2. With two weights #8's cdf [0, pdf_0, pdf_0 + pdf_1]
    is the plain version's bits (one add for the sum, one for the scan),
    and so are its samples before the fix-up. Returns (z_c, w, u)."""
    g = torch.Generator().manual_seed(seed)
    z_c = torch.stack([torch.rand(n, generator=g) * 0.01,
                       0.01 + torch.rand(n, generator=g) * 0.1,
                       0.3 + torch.rand(n, generator=g) * 0.5,
                       1.8 + torch.rand(n, generator=g)], 1)
    w = torch.rand(n, 2, generator=g)
    one = torch.ones(n, 1)
    return z_c, w, torch.cat([torch.nextafter(one, torch.zeros_like(one)),
                              one], 1)


@pytest.mark.cuda
def test_pdf_merge_kernel_sorts_inverted_samples(cuda_device):
    """The fix-up: on rows whose plain samples come out inverted, #8's
    samples are the plain samples sorted and its merged rows the plain
    merged rows, bit for bit."""
    z_c, w, u = inversion_problem(65536)
    want, want_s = pdf_merge.plain_sample_pdf_merged(z_c, w, u)
    inverted = int((want_s[:, 1] < want_s[:, 0]).sum())
    print(f"pdf_merge: {inverted} inverted rows of {z_c.shape[0]}")
    assert inverted > 0
    merged, z_s = pdf_merge.sample_pdf_merged(
        *[x.to(cuda_device) for x in (z_c, w, u)])
    assert torch.equal(z_s.cpu(), torch.sort(want_s, -1).values)
    assert torch.equal(merged.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,weights", [
    (1001, 96, "squared"), (1001, 96, "zero"), (1001, 96, "onehot"),
    (1, 96, "squared"), (7, 96, "squared"), (8193, 96, "squared"),
    (300, 1, "squared"), (300, 127, "squared"), (300, 127, "onehot")])
@pytest.mark.parametrize("jitter", [None, "single", "full"])
def test_mip_resample_kernel_matches_plain(cuda_device, n, s, weights,
                                           jitter):
    """#9 at ragged ray counts, the row limits (2 and 128 fenceposts) and
    degenerate weights (all zero with no padding: the eps deficit):
    within 1e-4 of (far - near) at the 99.9th percentile and one bin at
    most; on views (weights and fenceposts slices of wider rows, the
    expanded draws) bit for bit the contiguous rows' result, and
    bit-identical again."""
    dev = cuda_device
    g = torch.Generator().manual_seed(1)
    t = torch.sort(torch.rand(n, s + 1, generator=g) * 4 + 2,
                   -1).values.to(dev)
    w = _pdf_weights(weights, n, s, g).to(dev)
    j = None
    if jitter is not None:
        d = 1 if jitter == "single" else s + 1
        j = (torch.rand(n, d, generator=g) * (1 / (s + 1) - 1.2e-7)).to(dev)
    from consistentnerf_tpu_torch.core import sampling

    u_view = sampling.piecewise_pdf_draws(j, (n,), s + 1, dev)
    u = u_view.contiguous()
    pad = 0.0 if weights == "zero" else 0.01  # zero: the eps deficit
    before = pdf_merge.mip_launches
    got = pdf_merge.mip_resample_t_vals(t, w, u, pad)
    torch.cuda.synchronize()
    assert pdf_merge.mip_launches == before + 1
    want = pdf_merge.plain_mip_resample_t_vals(t, w, u, pad)
    print(f"mip_resample {n} x {s + 1} {weights} jitter={jitter}: max "
          f"{(got - want).abs().max().item() / 4.0:.3e}")
    _resample_gates(got, want, 4.0, s)
    t_view = torch.cat([t, t], 1)[:, :s + 1]
    w_view = torch.cat([w, w], 1)[:, :s]
    assert torch.equal(got, pdf_merge.mip_resample_t_vals(t_view, w_view,
                                                          u_view, pad))
    assert torch.equal(got, pdf_merge.mip_resample_t_vals(t, w, u, pad))


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
    also at a depth-5 skip into the heads and at multires 21; in fp32 #11
    runs the fp32 level walk and #14 keeps train_block."""
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
            assert plan(symbol, lib, n, bf16=0)[8] == (
                symbol == v2.ROW_BWD_KERNEL)
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
    row-major staging's 9 x 64 floats more shared memory; in fp32 too, on
    the fp32 level walk (slot 8 is 1)."""
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
        assert plan(fmip.ROW_BWD_KERNEL, n, bf16=0)[8] == 1


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


def _image_pair(h, w, seed):
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand((h, w, 3), generator=g)
    pred = torch.clamp(gt + 0.05 * torch.randn((h, w, 3), generator=g), 0, 1)
    mask = (torch.rand((h, w), generator=g) > 0.5).float()
    return pred, gt, mask


# The eval gates of chip_smoke.py: a metric on the card against the same
# port function on the CPU, relative; LPIPS (and avg_err, which holds it)
# with TF32 off (fm.strict_fp32).
EVAL_TOL = 1e-4
EVAL_LPIPS_TOL = 1e-3


@pytest.mark.cuda
def test_metric_suite_on_the_card_matches_the_cpu(cuda_device):
    """Every metric of compute_image_metrics (MS-SSIM at 200 pixels a
    side, LPIPS, the masked trio) on the card against the CPU."""
    from consistentnerf_tpu_torch.train import evaluation
    from consistentnerf_tpu_torch.train.lpips import LPIPS

    pred, gt, mask = _image_pair(200, 216, 3)
    cpu = evaluation.compute_image_metrics(pred, gt, LPIPS(device="cpu"),
                                         mask)
    card = evaluation.compute_image_metrics(
        pred.to(cuda_device), gt.to(cuda_device), LPIPS(device=cuda_device),
        mask.to(cuda_device))
    assert sorted(card) == sorted(cpu) and "ms_ssim" in card
    for k, v in cpu.items():
        tol = EVAL_LPIPS_TOL if "lpips" in k or k == "avg_err" else EVAL_TOL
        assert abs(card[k] - v) <= tol * max(abs(v), 1e-6), (k, card[k], v)


def _evaluate_case(device, **kw):
    """A model on the card (fp32 and plain unless `kw` says otherwise), the
    6-view 48x48 synthetic scene, five test views in evaluate()'s groups
    of two."""
    from consistentnerf_tpu_torch.data import synthetic

    cfg = configs.Config(**{**dict(
        netdepth=2, netwidth=32, N_samples=8, N_importance=8, multires=4,
        multires_views=2, white_bkgd=True, render_chunk_size=1024,
        eval_views_per_call=2), **kw})
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    return cfg, scene, make_model(cfg, device).eval(), [0, 1, 2, 3, 4]


def _cpu_metrics(model, cfg, scene, views, device):
    """The metric suite on the CPU, averaged over the views, of the card's
    renders in evaluate()'s groups (its own `render_groups`)."""
    import numpy as np

    from consistentnerf_tpu_torch.train import evaluation
    from consistentnerf_tpu_torch.train.lpips import LPIPS

    render = render_lib.build_render_fn(model, cfg)
    selected = evaluation.selected_views(cfg, views)
    g = evaluation.views_per_call(cfg, device, len(selected))
    assert g == 2
    per_view = []
    with torch.no_grad():
        for group, outs in evaluation.render_groups(render, scene, selected,
                                                    g, device):
            for (_, v), view in zip(group, outs):
                per_view.append(evaluation.compute_image_metrics(
                    torch.clamp(view["rgb"], 0, 1).cpu().numpy(),
                    scene.images[v], LPIPS(device="cpu")))
    return {k: float(np.mean([m[k] for m in per_view]))
            for k in per_view[0]}


@pytest.mark.cuda
def test_evaluate_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """evaluate() of an fp32 model on the card against the metric suite
    on the CPU, on the same renders (the card's, in evaluate()'s groups of
    two views): the same keys, values within the eval gates."""
    import numpy as np

    from consistentnerf_tpu_torch.train import evaluation

    cfg, scene, model, views = _evaluate_case(cuda_device)
    got = evaluation.evaluate(model, cfg, scene, out_dir=str(tmp_path),
                              views=np.asarray(views))
    want = _cpu_metrics(model, cfg, scene, views, cuda_device)
    assert sorted(got) == sorted(list(want) + ["eval_rays_per_sec"])
    for k, v in want.items():
        tol = EVAL_LPIPS_TOL if "lpips" in k or k == "avg_err" else EVAL_TOL
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-6), (k, got[k], v)


@pytest.mark.cuda
def test_evaluate_turns_tf32_off_on_the_card(cuda_device):
    """evaluate() owns its precision: with TF32 on again (cuDNN's default)
    before the call, it runs the metric suite in full fp32 and its LPIPS
    holds to the CPU's within the eval gate. The model renders in bf16
    through #1, a path that sets no precision flag of its own, as the
    flagship eval does."""
    import numpy as np

    from consistentnerf_tpu_torch.train import evaluation

    cfg, scene, model, views = _evaluate_case(
        cuda_device, netdepth=8, netwidth=64, N_samples=16, N_importance=16,
        multires=10, multires_views=4, compute_dtype="bfloat16",
        use_fused_render=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    v2.launches = 0
    got = evaluation.evaluate(model, cfg, scene, views=np.asarray(views),
                              save_images=False)
    assert v2.launches > 0
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    want = _cpu_metrics(model, cfg, scene, views, cuda_device)
    for k in ("lpips", "avg_err"):
        assert abs(got[k] - want[k]) <= EVAL_LPIPS_TOL * max(
            abs(want[k]), 1e-6), (k, got[k], want[k])


# --- ss_loss on the one-pass step (the reference rays' levels) -----------


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_onepass_ss_loss_step_matches_plain_path(cuda_device, dtype, gate):
    """The one-pass step with ss_loss on the card (8x256, 64 + 128
    samples, 256 + 8x8 rays): #3 launches four times, the reference rays'
    coarse and fine levels (every ray) held against the packed walk on
    the same inputs at the tolerances of the #3 tests above, and the
    step's loss, ss_loss and grads against the eager step (the plain path)
    with the same draws, for both gate values, at chip_smoke.py's guard
    tolerances."""
    import copy

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    dev = cuda_device
    cfg = configs.Config(N_samples=64, N_importance=128, N_rand=256,
                         n_patches=1, patch_size=8, hardmask=True,
                         with_depth_loss=True, white_bkgd=True,
                         compute_dtype=dtype, ss_loss=True,
                         use_fused_train=True, use_onepass_train=True)
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    batch = to_device(VanillaBatcher(scene, cfg).next_batch(), dev)
    n = batch["rgb"].shape[0]
    state = loop.init_state(cfg, dev)
    draws = step_lib.make_draws(cfg, n, torch.Generator(dev).manual_seed(5),
                                dev)
    draws["ss"]["gate"] = torch.tensor(gate, device=dev)
    calls, real = [], op.onepass_level

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    op.onepass_level = spy
    try:
        before = op.launches
        _, stats_k = op.build_onepass_vanilla_train_step(cfg)(
            copy.deepcopy(state), batch, draws)
    finally:
        op.onepass_level = real
    torch.cuda.synchronize()
    assert op.launches == before + 4
    assert [c[0][3].shape[0] for c in calls] == [n - 64, n - 64, n, n]
    for a, k, (out, dw) in calls[2:]:  # the reference rays' levels
        want_out, want_dw = op.packed_onepass_reference(
            a[0], *a[1:9], k["white_bkgd"])
        assert torch.isfinite(out).all()
        rows_rel = ((out - want_out).abs().amax(1)
                    / want_out.abs().amax(1).clamp_min(1e-30)).max().item()
        assert rows_rel < {"bfloat16": 5e-3, "float32": 1e-4}[dtype]
        assert _rel(dw, want_dw) < TRAIN_TOL[dtype]
    eager = step_lib.build_vanilla_train_step(state.model, cfg)
    _, stats_e = eager(copy.deepcopy(state), batch, draws)
    for key in ("loss", "ss_loss"):
        k_, e_ = float(stats_k[key]), float(stats_e[key])
        assert abs(k_ - e_) < 1e-2 * abs(e_), (key, k_, e_)
    norm_rel = abs(float(stats_k["grad_norm"])
                   / float(stats_e["grad_norm"]) - 1)
    assert norm_rel < 5e-2


# --- the depth-prior producers on the card ---------------------------------


@pytest.mark.cuda
def test_mvs_supervised_training_beats_baselines(cuda_device):
    """~120 GT-supervised MVS steps on the card (the sphere, 6 views,
    48x48, 16 planes, base width 4; tests/test_mvs.py's twin): the
    trained prior's depth-MSE on valid pixels is under half the untrained
    net's and under half the best constant depth's."""
    import numpy as np

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.train import mvs as mvs_train

    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    cfg = configs.Config(dataset_type="synthetic", mvs_num_depths=16,
                         mvs_base_ch=4, mvs_n_src=2, mvs_lr=3e-3)
    dev = cuda_device
    untrained = mvs_train.make_net(cfg, "cpu").state_dict()
    priors0 = mvs_train.predict_depth_priors(cfg, scene, untrained,
                                             conf_thresh=0.0, device=dev)
    result = mvs_train.train_mvs_depth(cfg, scene, num_steps=120,
                                       log_fn=lambda s: None, device=dev)
    priors = mvs_train.predict_depth_priors(cfg, scene, result.params,
                                            conf_thresh=0.0, device=dev)
    tr = np.asarray(scene.i_train)
    gt = scene.depths[tr]
    valid = gt > 0

    def mse(pred):
        return float(np.mean((pred[tr][valid] - gt[valid]) ** 2))

    const_best = min(float(np.mean((c - gt[valid]) ** 2))
                     for c in np.linspace(scene.near, scene.far, 17))
    assert mse(priors) < 0.5 * mse(priors0), (mse(priors), mse(priors0))
    assert mse(priors) < 0.5 * const_best, (mse(priors), const_best)


@pytest.mark.cuda
def test_mvs_predict_gives_the_same_bits_twice(cuda_device):
    """Two predicts of every train view from the same params, at the JAX
    package's MVS defaults (32 planes, base width 8, 2 sources) on the
    sphere at 200x200, give the same bits: the depths everywhere (a
    threshold of 0 keeps every pixel), and the priors at the default
    threshold."""
    import numpy as np

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.train import mvs as mvs_train

    scene = synthetic.make_scene(n_views=6, H=200, W=200).to_scene_data()
    cfg = configs.Config(dataset_type="synthetic")
    params = mvs_train.make_net(cfg, "cpu").state_dict()
    for thresh in (0.0, None):
        first, again = (mvs_train.predict_depth_priors(
            cfg, scene, params, conf_thresh=thresh, device=cuda_device)
            for _ in range(2))
        assert np.isfinite(first).all()
        assert np.array_equal(first, again), thresh


@pytest.mark.cuda
def test_bootstrap_priors_end_to_end(cuda_device, tmp_path):
    """The warmup bootstrap on the card at tests/test_bootstrap.py's
    settings (500 warmup steps, 2x64 vanilla model, the sphere at 48x48,
    seed 0), then 500 consistent retrain steps: plausible masks, priors
    accurate inside them, fusion no worse than the raw warmup depths, a
    finite retrain above 8 dB.

    The JAX test also bounds the retrain against the warmup (held-out
    depth-MSE under 1.3x, PSNR within 2.5 dB). Those bounds are not a
    property of the code at this size: on a CPU the JAX package's own
    flow meets both at 1 of seeds 0-5 (depth x0.69 to x7.19, PSNR +0.9
    to -4.0 dB; `tools/bootstrap_seeds.py jax`), the port's at 3 of
    them, two after a warmup that saw nothing (depth x0.41 to x4.48,
    PSNR +0.3 to -8.7 dB; `tools/bootstrap_seeds.py port`). The held-out
    numbers follow the init sample: from one init, both packages'
    warmups land together, a warmup that sees nothing included
    (`tools/bootstrap_seeds.py crossed`). So this twin prints the
    comparison and does not gate on it; the flow is held against the JAX
    package deterministically, from a carried init at perturb 0, by
    `tests/test_torch_port_bootstrap.py::
    test_bootstrap_flow_tracks_jax_from_a_carried_init`."""
    import numpy as np

    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.train import bootstrap, loop
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    dev = cuda_device
    steps = 500
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    cfg = configs.Config(
        backbone="vanilla", netdepth=2, netwidth=64, N_samples=16,
        N_importance=8, multires=4, multires_views=2, N_rand=192,
        n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
        hardmask=True, with_depth_loss=True, use_tensorboard=False,
        i_print=1000, checkpoint_every=100000, total_iters=steps,
        lrate=5e-3, basedir=str(tmp_path), expname="boot")
    boot, warm = bootstrap.bootstrap_scene_priors(
        cfg, scene, steps, log_fn=lambda s: None,
        export_dir=str(tmp_path / "priors"), device=dev)
    tr = np.asarray(scene.i_train)
    assert (tmp_path / "priors" / f"depth_{tr[0]:04d}.pfm").is_file()
    frac = float(boot.masks[tr].mean())
    assert 0.02 < frac < 0.95, frac
    m = (boot.masks[tr] > 0) & (scene.depths[tr] > 0)
    prior_mse = float(np.mean((boot.depths[tr][m]
                               - scene.depths[tr][m]) ** 2))
    assert prior_mse < 0.2, prior_mse
    warm_cfg = bootstrap.warmup_config(cfg, steps)
    raw = bootstrap.render_warmup_depths(warm_cfg, scene,
                                         warm.state.model.eval())
    fused = reproject.fuse_depth_priors(scene.poses, raw, scene.K, tr,
                                        scene.H, scene.W, device=dev)
    m_raw = (raw[tr] > 0) & (scene.depths[tr] > 0)
    m_fu = (fused[tr] > 0) & (scene.depths[tr] > 0)
    mse_raw = float(np.mean((raw[tr][m_raw] - scene.depths[tr][m_raw]) ** 2))
    mse_fu = float(np.mean((fused[tr][m_fu] - scene.depths[tr][m_fu]) ** 2))
    assert mse_fu <= mse_raw * 1.05, (mse_fu, mse_raw)
    assert float(np.mean(m_fu)) > 0.3 * float(np.mean(m_raw))

    def heldout(model, c):
        render = render_lib.build_render_fn(model.eval(), c)
        derr, psnr = [], []
        for vid in scene.i_test:
            out = render(camera_rays_for_view(scene, scene.poses[vid],
                                              device=dev))
            gt_d = scene.depths[vid]
            sel = gt_d > 0
            derr.append(float(np.mean(
                (out["depth"].cpu().numpy()[sel] - gt_d[sel]) ** 2)))
            pred = np.clip(out["rgb"].cpu().numpy(), 0, 1)
            psnr.append(float(-10 * np.log10(np.mean(
                (pred - scene.images[vid]) ** 2))))
        return float(np.mean(derr)), float(np.mean(psnr))

    w_derr, w_psnr = heldout(warm.state.model, warm_cfg)
    result = loop.train(cfg, boot, num_steps=steps, device=dev,
                        log_fn=lambda s: None)
    b_derr, b_psnr = heldout(result.state.model, cfg)
    print(f"held-out depth-MSE warmup {w_derr:.4f} retrain {b_derr:.4f} "
          f"(x{b_derr / w_derr:.2f}); PSNR warmup {w_psnr:.2f} retrain "
          f"{b_psnr:.2f} ({b_psnr - w_psnr:+.2f} dB)")
    assert np.isfinite(b_derr) and np.isfinite(b_psnr) and b_psnr > 8.0


# ------------------- the whole trainer and its checkpoints -------------------

TINY_TRAIN = dict(backbone="vanilla", netdepth=8, netwidth=256, N_samples=16,
                  N_importance=16, N_rand=256, n_patches=4, patch_size=16,
                  hardmask=True, with_depth_loss=True, white_bkgd=True,
                  compute_dtype="bfloat16", perturb=1.0,
                  use_fused_train=True, use_onepass_train=True)


def _lpips_file(path):
    """The port's seeded LPIPS init in the `.npz` export format."""
    from consistentnerf_tpu_torch.train import lpips

    lpips.save_weights(str(path), lpips.init_params(0))
    return str(path)


def _step_grads(step_fn, state, batch, draws):
    """(stats, the grads the optimizer's update reads) of one step."""
    grads = []
    real = state.optimizer.step

    def keep(count):
        grads.extend(torch.zeros_like(p) if p.grad is None else
                     p.grad.detach().clone() for p in state.model.parameters())
        real(count)

    state.optimizer.step = keep
    _, stats = step_fn(state, batch, draws)
    return stats, grads


def _rel_l2(a, b):
    return (torch.linalg.norm(a.float().cpu() - b.float().cpu())
            / torch.linalg.norm(b.float().cpu()).clamp_min(1e-30)).item()


@pytest.mark.cuda
def test_onepass_step_with_lpips_matches_eager_on_the_card(cuda_device,
                                                           tmp_path):
    """The one-pass step with the train-time LPIPS term (patch rays
    through #1 / #2 with autograd, the rest through #3) against the eager
    step on the card, bf16, from the same state, batch and draws."""
    import copy

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.ops import fused_onepass as op
    from consistentnerf_tpu_torch.train import loop, step as step_lib

    cfg = configs.Config(**TINY_TRAIN,
                         lpips_weights_path=_lpips_file(tmp_path / "l.npz"))
    lp = loop.train_lpips_params(cfg, cuda_device)
    scene = synthetic.make_scene(n_views=4, H=48, W=48).to_scene_data()
    batch = to_device(VanillaBatcher(scene, cfg).next_batch(), cuda_device)
    draws = step_lib.make_draws(cfg, batch["rgb"].shape[0],
                                step_lib.step_generator(0, 0, cuda_device),
                                cuda_device)
    state = loop.init_state(cfg, cuda_device)
    before = (v2.launches, v2.bwd_launches, op.launches)
    st_k, g_k = _step_grads(op.build_onepass_vanilla_train_step(
        cfg, lpips_params=lp), copy.deepcopy(state), batch, draws)
    torch.cuda.synchronize()
    assert (v2.launches - before[0], v2.bwd_launches - before[1],
            op.launches - before[2]) == (2, 2, 2)
    st_e, g_e = _step_grads(step_lib.build_vanilla_train_step(
        None, cfg, lpips_params=lp), copy.deepcopy(state), batch, draws)
    assert float(st_e["patch_lpips"]) > 0
    assert abs(float(st_k["patch_lpips"]) / float(st_e["patch_lpips"])
               - 1) < 1e-2
    assert abs(float(st_k["loss"]) / float(st_e["loss"]) - 1) < 1e-2
    # bf16: the grads as one vector (a small leaf's own relative error
    # reached 5.1e-2 on an H100 at this size).
    assert _rel_l2(torch.cat([g.reshape(-1) for g in g_k]),
                torch.cat([g.reshape(-1) for g in g_e])) < 5e-2


@pytest.mark.cuda
def test_lpips_term_and_noisy_and_normals_steps_match_the_cpu(cuda_device):
    """fp32 in strict mode: the LPIPS term and its gradient on 16x16
    patches, the eager vanilla step with density noise and the eager mip
    step with normals, each on the card against the CPU from the same
    inputs and draws."""
    import copy

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (MipBatcher,
                                                        VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.train import loop, lpips
    from consistentnerf_tpu_torch.train import step as step_lib

    params = lpips.init_params(0)
    g = torch.Generator().manual_seed(0)
    gt = torch.rand(4, 16, 16, 3, generator=g)
    pred = (gt + 0.1 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        x = pred.to(dev).requires_grad_()
        val = lpips.lpips(lpips.params_to(params, dev), x * 2 - 1,
                          gt.to(dev) * 2 - 1).mean()
        val.backward()
        out[dev.type] = (val.item(), x.grad.cpu())
    assert abs(out["cuda"][0] / out["cpu"][0] - 1) < 1e-4
    assert _rel_l2(out["cuda"][1], out["cpu"][1]) < 1e-3

    scene = synthetic.make_scene(n_views=4, H=48, W=48).to_scene_data()

    def move(x, dev):
        if isinstance(x, dict):
            return {k: move(v, dev) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v, dev) for v in x]
        if hasattr(x, "map"):
            return x.map(lambda t: t.to(dev))
        return x.to(dev) if torch.is_tensor(x) else x

    cases = []
    n_cfg = configs.Config(**{**TINY_TRAIN, "compute_dtype": "float32",
                              "raw_noise_std": 1.0, "n_patches": 1,
                              "use_fused_train": False})
    b = to_device(VanillaBatcher(scene, n_cfg).next_batch(), "cpu")
    d = step_lib.make_draws(n_cfg, b["rgb"].shape[0],
                            torch.Generator().manual_seed(1), "cpu")
    assert {"noise_c", "noise_f"} <= set(d)
    cases.append((n_cfg, step_lib.build_vanilla_train_step, b, d))
    m_cfg = configs.Config(backbone="mipnerf", netdepth=8, netwidth=256,
                           mip_num_samples=16, N_rand=128,
                           disable_normals=False,
                           compute_normal_metrics=True, white_bkgd=True,
                           randomized=True, density_noise=1.0)
    mb = to_device(MipBatcher(scene, m_cfg).next_batch(), "cpu")
    md = step_lib.make_mip_step_draws(m_cfg, mb,
                                      torch.Generator().manual_seed(2), "cpu")
    cases.append((m_cfg, step_lib.build_mip_train_step, mb, md))
    for cfg, build, batch, draws in cases:
        state = loop.init_state(cfg, "cpu")
        res = {}
        for dev in (cuda_device, torch.device("cpu")):
            st = copy.deepcopy(state)
            st.model.to(dev)
            res[dev.type] = _step_grads(build(None, cfg), st,
                                        move(batch, dev), move(draws, dev))
        (st_k, g_k), (st_c, g_c) = res["cuda"], res["cpu"]
        assert abs(float(st_k["loss"]) / float(st_c["loss"]) - 1) < 1e-4
        assert max(_rel_l2(a, b_) for a, b_ in zip(g_k, g_c)) < 1e-2


@pytest.mark.cuda
def test_train_loop_housekeeping_on_the_card(cuda_device, tmp_path):
    """train() on the card with prefetch, a profiler trace of 2 steps (it
    names #3), a held-out render through #1, gc_every and the LPIPS term,
    then the checkpoint exported, imported and rendered bit for bit as
    the original."""
    import json
    import os

    from consistentnerf_tpu_torch.cli import export_torch_ckpt
    from consistentnerf_tpu_torch.cli import import_torch_ckpt
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.ops import fused_onepass as op
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    npz = _lpips_file(tmp_path / "l.npz")
    cfg = configs.Config(**TINY_TRAIN, lpips_weights_path=npz,
                         profile_steps=2, train_render_every=4, gc_every=2,
                         use_fused_render=True, use_tensorboard=False,
                         basedir=str(tmp_path), expname="hk", i_print=1)
    scene = synthetic.make_scene(n_views=4, H=48, W=48).to_scene_data()
    said = []
    res = loop.train(cfg, scene, num_steps=4, device=cuda_device,
                     log_fn=said.append)
    assert res.state.step == 4
    assert any(m.startswith("  test render @ 4:") for m in said)
    trace = os.path.join(tmp_path, "hk", "profile", "train_steps_1-2.json")
    with open(trace) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    assert any(op.KERNEL in n for n in names)
    tar = str(tmp_path / "hk.tar")
    sets = ["backbone=vanilla", "netdepth=8", "netwidth=256",
            "N_samples=16", "N_importance=16", "compute_dtype=bfloat16",
            "use_fused_render=true", f"basedir={tmp_path}"]

    def args(exp):
        return ["--device", "cuda"] + [x for s in sets + [f"expname={exp}"]
                                       for x in ("--set", s)]

    assert export_torch_ckpt.main([tar] + args("hk")) == 4
    import_torch_ckpt.main([tar] + args("rt"))
    renders = []
    for exp in ("hk", "rt"):
        model = make_model(cfg, cuda_device)
        CheckpointManager(os.path.join(tmp_path, exp, "checkpoints")
                          ).restore_for_eval(model)
        before = v2.launches
        renders.append(render_lib.build_render_fn(model.eval(), cfg)(
            camera_rays_for_view(scene, scene.poses[0], device=cuda_device)))
        torch.cuda.synchronize()
        assert v2.launches > before
    assert all(torch.equal(renders[0][k], renders[1][k])
               for k in ("rgb", "depth"))


def _msgpack(obj) -> bytes:
    """flax's msgpack encoding of a tree of string-keyed maps and numpy
    arrays / scalars (extensions 1 and 3: a packed (shape, dtype name,
    bytes)), written here: the card's machine has neither flax nor
    msgpack."""
    import struct

    import numpy as np

    if isinstance(obj, dict):
        return b"\xde" + struct.pack(">H", len(obj)) + b"".join(
            _msgpack(str(k)) + _msgpack(v) for k, v in obj.items())
    if isinstance(obj, str):
        return b"\xda" + struct.pack(">H", len(obj)) + obj.encode()
    if isinstance(obj, list):
        return b"\xdc" + struct.pack(">H", len(obj)) + b"".join(
            _msgpack(x) for x in obj)
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, int):
        return b"\xd3" + struct.pack(">q", obj)
    arr = np.array(obj, order="C")  # a scalar stays 0-d
    payload = _msgpack([list(arr.shape), arr.dtype.name, arr.tobytes()])
    code = 1 if isinstance(obj, np.ndarray) else 3
    return b"\xc9" + struct.pack(">Ib", len(payload), code) + payload


@pytest.mark.cuda
def test_mip_import_renders_through_the_fused_forward(cuda_device,
                                                      tmp_path):
    """A flax msgpack file of the pretrained layout -> a mip checkpoint,
    rendered through #6 (bf16) against the plain render."""
    import numpy as np

    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.cli import import_mipnerf_ckpt
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager

    cfg = configs.Config(backbone="mipnerf", netdepth=8, netwidth=256,
                         mip_num_samples=32, compute_dtype="bfloat16",
                         use_fused_render=True, white_bkgd=True)
    src = make_model(cfg, "cpu")
    tree = interop.mip_params_to_jax(src.state_dict())
    tree = {"optimizer": {"target": tree, "state": {"step": np.int32(9)}}}
    path = tmp_path / "checkpoint_9"
    path.write_bytes(_msgpack(tree))
    state = import_mipnerf_ckpt.import_checkpoint(str(path), cfg,
                                                  cuda_device)
    CheckpointManager(str(tmp_path / "ckpt")).save(state.step, state)
    g = torch.Generator().manual_seed(3)
    n = 4096
    d = torch.randn(n, 3, generator=g) * 0.2
    d[:, 2] = -1
    ones = torch.ones(n, 1)
    rays = Rays(origins=torch.zeros(n, 3), directions=d,
                viewdirs=d / d.norm(dim=-1, keepdim=True),
                radii=ones * 1e-3, lossmult=ones, near=ones * 2,
                far=ones * 6).map(lambda t: t.to(cuda_device))
    model = state.model.eval()
    before = fmip.launches
    fused = render_lib.build_render_fn(model, cfg)(rays)
    torch.cuda.synchronize()
    assert fmip.launches - before == cfg.mip_num_levels
    plain = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(rays)
    assert (fused["rgb"] - plain["rgb"]).abs().mean().item() < 2e-3


def _chip_smoke():
    """chip_smoke.py's phases (the repository root on the path)."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    chip_smoke.torch = torch
    return chip_smoke


def _build_all():
    """Build every kernel before rank processes load them (two processes
    must not build one source at once)."""
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_onepass as op

    _build.build_all([v2.KERNEL, v2.BWD_KERNEL, op.KERNEL, op.MIP_KERNEL,
                      fmip.KERNEL, fmip.BWD_KERNEL])


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_process(cuda_device,
                                                      tmp_path):
    """chip_smoke.py's distributed phase at a small size: the one-pass
    vanilla step (hard masks uneven over the ranks), with ss_loss, and
    the one-pass mip step over two gloo ranks on this card against one
    process on the whole batches (ranks bit-identical, step-1 loss and
    grads, each rank's launches of #1 / #2 / #3 / #5 / #6 / #7), the
    sharded render against the whole one, and a 1-rank NCCL group giving
    the unsharded step's bits."""
    cs = _chip_smoke()
    _build_all()
    small = dict(netdepth=2, netwidth=64, N_samples=16, N_importance=32,
                 N_rand=512)
    cases = {"vanilla": dict(cs.FLAGSHIP, **small),
             "vanilla_ss": dict(cs.FLAGSHIP, ss_loss=True, **small),
             "mip": dict(cs.MIP, netdepth=2, netwidth=64,
                         mip_num_samples=32, N_rand=512)}
    cs.GATE_FAILURES.clear()
    launches = cs.distributed_phases(cuda_device, "card", cases,
                                     dict(n_views=4, H=64, W=64),
                                     str(tmp_path))
    assert not cs.GATE_FAILURES, cs.GATE_FAILURES
    assert all(launches[k] > 0 for k in (v2.KERNEL, v2.BWD_KERNEL))


@pytest.mark.cuda
def test_interleaved_canary_from_the_jax_init(cuda_device, tmp_path):
    """The interleaved canary (tests/test_generalization_canary.py) from
    the JAX package's init through train() on the card, held to the JAX
    test's bounds."""
    import numpy as np

    cs = _chip_smoke()
    res = cs.run_canary("interleaved", "jax", cuda_device, str(tmp_path))
    assert min(res["psnrs"]) > 11.0, res
    assert float(np.mean(res["psnrs"])) > 12.5, res


@pytest.mark.cuda
def test_jpeg_fixtures_match_their_digests(cuda_device):
    """The committed JPEG fixtures through the port's decoder on the
    card's machine (which has no imaging package), against the SHA-256
    of imageio's decode stored beside them (tools/jpeg_fixtures.py)."""
    import hashlib
    import json
    import os

    from consistentnerf_tpu_torch.data import images

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jpeg_fixtures.json")) as f:
        index = json.load(f)
    assert len(index) >= 4
    for name, want in index.items():
        img = images.imread(os.path.join(here, "jpeg_fixtures", name))
        assert list(img.shape) == want["shape"], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], \
            name


@pytest.mark.cuda
def test_viewdir_free_mip_eager_step_matches_the_cpu(cuda_device):
    """The mip eager step without view directions at the mip width (8x256,
    96 x 2 samples), fp32 in strict mode, 256 rays: the card against the
    CPU from the same state and batch, at perturb 0. The loss within
    1e-5, the grads within 3e-4 relative L2 together and 3e-3 a tensor:
    3x the step's own fp32 floor (a one-ulp nudge of the origins moves
    the CPU's grads ~1.1e-4 / ~1e-3; chip_smoke.py's NOVIEW_* gates)."""
    import copy

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    cfg = configs.Config(backbone="mipnerf", use_viewdirs=False,
                         mip_num_samples=96, N_rand=256, white_bkgd=True,
                         randomized=False, compute_depth_metrics=True,
                         compute_mono_depth_metrics=False,
                         dataset_type="blender")
    scene = synthetic.make_scene(n_views=4, H=64, W=64).to_scene_data()
    full = to_device(MipBatcher(scene, cfg).next_batch(), "cpu")
    n = full["rgb"].shape[0]
    batch = {k: (v.map(lambda t: t[-256:]) if hasattr(v, "map")
                 else v[-256:] if v.shape[:1] == (n,) else v)
             for k, v in full.items()}
    state = loop.init_state(cfg, "cpu")
    assert len(list(state.model.mlp.dense)) == 10
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        st = copy.deepcopy(state)
        st.model.to(dev)
        b = {k: (v.map(lambda t: t.to(dev)) if hasattr(v, "map")
                 else v.to(dev)) for k, v in batch.items()}
        res[dev.type] = _step_grads(step_lib.build_mip_train_step(None, cfg),
                                    st, b, {})
    (st_k, g_k), (st_c, g_c) = res["cuda"], res["cpu"]
    assert abs(float(st_k["loss"]) / float(st_c["loss"]) - 1) < 1e-5
    assert _rel_l2(torch.cat([g.reshape(-1).cpu() for g in g_k]),
                   torch.cat([g.reshape(-1) for g in g_c])) < 3e-4
    assert max(_rel_l2(a, b) for a, b in zip(g_k, g_c)) < 3e-3
