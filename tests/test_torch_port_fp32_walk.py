"""The fp32 level walk of #2, #3 and #11 on the CPU: its arithmetic and
the buffers it reads.

In fp32 the train kernels #3 (`csrc/onepass_level.cu`), #2 and #11
(`csrc/fused_mlp_bwd.cu`) run `csrc/level_train.cuh`'s walk with the
backward's products and the dW as six bf16 products a fp32 product (the
forward on the CUDA cores): each operand split into hi, mid and lo bf16
terms (`ops/fused_mlp_v2.py::split3`), the weights by the host into
three planes of the packed layout (`PackedMLP.w3`). Held here: the split
is exact; the planes have the shapes and offsets the kernel's weight maps
read; the walk's shared memory fits a block at the presets' shapes; the
six-product GEMM (`six_products`, the plain version of the walk's
products) agrees with the fp32 matmul; the packed walks of #2 and #3
computed with it agree with the JAX package's fp32 `_bwd_pallas_T` and
`onepass_level_T` (interpret mode, as the JAX tests run them), at the
parity tolerances of `tests/test_torch_port_train_kernels.py`; and the
sources route fp32 #2, #3 and #11 to the walk and pass it the planes.
The kernels themselves run on the card (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`).
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_v2 as jv2
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "consistentnerf_tpu_torch" / \
    "csrc"
DEPTH, WIDTH, SKIPS, MR, MV = 4, 32, (2,), 4, 2
N_RAYS, SEG = 12, 16
# The JAX package's own bound for its kernels' weight grads, as
# tests/test_torch_port_train_kernels.py holds the packed walks.
DW_TOL = dict(atol=2e-4, rtol=2e-3)


# ------------------------------ the split ---------------------------------


def _edge_values():
    """Values where the split's roundings carry or tie: exact bf16 values,
    ones whose hi rounds up into the next binade, mid and lo terms of
    either sign, ties to even at each cut, the range's ends."""
    bits = [0x3F800000, 0x3FFFFFFF, 0x3F7FFFFF, 0x3F808080, 0x3F80FF80,
            0x3F8000FF, 0x3F807FFF, 0x3F808000, 0x3F818000, 0x3F800080,
            0x3F800180, 0x4B7FFFFF, 0x0D800000, 0x0DFFFFFF, 0x7F7EFFFF,
            0x7F000001, 0x00000000]
    x = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
    return torch.cat([x, -x])


def test_split3_is_exact():
    """hi + mid + lo == x, summed as the kernel unsplits (hi + mid, then
    + lo, in fp32), for seeded normals over the range 2^-100 .. 2^100 and
    for the edge values; each plane is bf16 and hi is x rounded to bf16."""
    rs = np.random.RandomState(0)
    mant = rs.uniform(1.0, 2.0, 200_000)
    expo = rs.randint(-100, 100, 200_000)
    sign = rs.choice([-1.0, 1.0], 200_000)
    x = torch.from_numpy((sign * np.ldexp(mant, expo)).astype(np.float32))
    x = torch.cat([x, _edge_values()])
    planes = v2.split3(x)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, x.numel())
    hi, mid, lo = planes.float()
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # Each term holds what the one before left: |mid| <= half an ulp of
    # hi's bf16, |lo| <= half an ulp of mid's.
    nz = hi != 0
    assert (mid[nz].abs() <= hi[nz].abs() * 2.0 ** -8).all()
    nz = mid != 0
    assert (lo[nz].abs() <= mid[nz].abs() * 2.0 ** -8).all()


def test_split3_of_a_tensor_keeps_its_shape():
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(1))
    planes = v2.split3(x)
    assert planes.shape == (3, 5, 7) and planes.is_contiguous()
    assert torch.equal(planes.float().sum(0), x)


# ----------------------------- the planes ---------------------------------


def _flat(depth=DEPTH, width=WIDTH, skips=SKIPS, mr=MR, mv=MV, seed=0):
    mlp = NeRFMLP(net_depth=depth, net_width=width, skips=skips,
                  input_ch=3 * (1 + 2 * mr), input_ch_views=3 * (1 + 2 * mv))
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return fm.flatten_params(mlp, True, depth)


@pytest.mark.parametrize("depth,width,skips,mr,mv", [
    (DEPTH, WIDTH, SKIPS, MR, MV), (8, 256, (4,), 10, 4)])
def test_packed_planes_are_the_kernel_maps(depth, width, skips, mr, mv):
    """An fp32 pack holds w3 = split3(w), [3, w.numel()] bf16: plane p of
    element i at p w.numel() + i. The walk's two weight maps read, in each
    plane, the trunk and feature rows [w_views / W, W] from the plane's
    start and the view layer's rows [W + V, H] from w_views
    (`hopper.cuh::weight_maps`): those windows are the planes of the
    packed blocks."""
    packed = v2.pack(_flat(depth, width, skips, mr, mv), depth, skips, mr,
                     mv, "float32")
    n_w = packed.w.numel()
    assert packed.w3.shape == (3, n_w) and packed.w3.is_contiguous()
    assert packed.w3.dtype == torch.bfloat16
    assert torch.equal(packed.w3, v2.split3(packed.w))
    w, _ = v2._packed_weights(packed)
    wshapes, _ = v2._block_shapes(packed)
    offsets, o = {}, 0
    for name, rows, cols in wshapes:
        offsets[name] = o
        o += rows * cols
    assert o == n_w
    w_views, h = offsets["views_0"], packed.view_width
    v = v2._pad16(3 * (1 + 2 * mv))
    flat3 = packed.w3.reshape(-1)
    for p in range(3):
        base = p * n_w
        trunk = flat3[base:base + w_views].reshape(-1, width)
        want = torch.cat([v2.split3(w[n])[p].reshape(-1, width)
                          for n, *_ in wshapes[:depth + 1]
                          if n.startswith("pts") or n == "feature"])
        assert torch.equal(trunk, want)
        views = flat3[base + w_views:base + w_views + (width + v) * h]
        assert torch.equal(views.reshape(width + v, h),
                           v2.split3(w["views_0"])[p])
    # TMA: 16-byte plane starts and row strides.
    assert (2 * n_w) % 16 == 0 and (2 * width) % 16 == 0
    v2.check_tma_weights(packed)
    v2.check_planes(packed)


def test_only_the_fp32_walks_packs_carry_planes():
    """bf16 packs, and the fp32 packs of the v1 kernels (#14 keeps
    train_block in fp32), carry no planes; the fp32 mip packs (#5, #7 and
    #16 on the fp32 level walk) carry them as the NeRF packs do; the
    planes' checks refuse what the kernel could not read."""
    flat = _flat()
    assert v2.pack(flat, DEPTH, SKIPS, MR, MV, "bfloat16").w3 is None
    assert fm.pack_v1(flat, DEPTH, SKIPS, MR, MV, "float32").w3 is None
    mlp = MipMLP(net_depth=4, net_width=32, net_width_viewdirs=16,
                 max_deg_point=4)
    mflat = fmip.flatten_mip_params(mlp, 4)
    assert fmip.pack(mflat, 4, 4, "bfloat16").w3 is None
    mpk = fmip.pack(mflat, 4, 4, "float32")
    assert torch.equal(mpk.w3, v2.split3(mpk.w))
    v2.check_planes(mpk)
    v2.check_tma_weights(mpk)
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    import dataclasses

    with pytest.raises(ValueError, match="w3"):
        v2.check_planes(dataclasses.replace(packed, w3=None))
    buf = torch.empty(3 * packed.w.numel() + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(3, -1)
    shifted.copy_(packed.w3)
    with pytest.raises(ValueError, match="aligned"):
        v2.check_tma_weights(dataclasses.replace(packed, w3=shifted))
    with pytest.raises(ValueError, match="planes"):
        v2.check_tma_weights(dataclasses.replace(packed,
                                                 w3=packed.w3[:2]))


@pytest.mark.parametrize("row", [False, True])
def test_fp32_walk_fits_a_block_at_the_presets_shapes(row):
    """The fp32 walk's shared memory at 8x256, multires 10 / 4 and
    768-row chunks (the fine level of the vanilla presets' random rays
    and patch rays; `row`: #11's staging): the weight ring, fp32 tiles (pe,
    ve, one activation tile), the chunk's rows and the column sums, with
    the static bytes under a block's 232,448; a second fp32 activation
    tile would not fit, so the walk keeps one, and its forward's second
    in the weight ring, which the stream fills only in the backward."""
    packed = v2.pack(_flat(8, 256, (4,), 10, 4), 8, (4,), 10, 4, "float32")
    got = fm.walk_smem_bytes(packed, 768, row)
    ring = 3 * 4 * 64 * 64 * 2 + 1024
    tiles = 4 * 64 * ((64 + 8) + (32 + 8) + (256 + 8))
    floats = 4 * (4 * 64 + 5 * 768 + 2 * 8 * 256 + (9 * 64 if row else 0))
    assert got == ring + tiles + floats == (230_656 if row else 228_352)
    assert got + fm.K_WALK_STATIC <= fm.SMEM_LIMIT
    assert got + 4 * 64 * (256 + 8) + fm.K_WALK_STATIC > fm.SMEM_LIMIT
    assert 4 * 64 * (256 + 8) <= fm.K_WSTAGES * fm.K_WSTAGE
    # bf16 keeps its figure (two bf16 activation tiles).
    bf = v2.pack(_flat(8, 256, (4,), 10, 4), 8, (4,), 10, 4, "bfloat16")
    assert fm.walk_smem_bytes(bf, 576) == 212_480


# ------------------------- the six-product GEMM ----------------------------


@pytest.mark.parametrize("k", [16, 63, 256, 4096])
def test_six_products_match_the_fp32_matmul(k):
    """six_products(a, b) against the product in fp64: as close as the
    fp32 matmul (~1e-7 relative here; the dropped terms are at 2^-24 of
    each product), and within ~1e-6 of the fp32 matmul."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn(64, k, generator=g)
    b = torch.randn(k, 96, generator=g) / k ** 0.5
    want = a.double() @ b.double()
    got = v2.six_products(a, b)
    assert got.dtype == torch.float32

    def rel(x):
        return (torch.linalg.norm(x.double() - want)
                / torch.linalg.norm(want)).item()
    fp32 = a @ b
    assert rel(got) < 1e-6 and rel(got) < 4 * rel(fp32) + 1e-7
    assert rel(got.double() - fp32.double() + want) < 1e-6
    # One bf16 product a product would be ~1e-3 off.
    one = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert rel(one) > 1e-4


def test_six_products_are_exact_on_bf16_operands():
    """Operands that are bf16 already have mid = lo = 0: the six products
    are the one product hi hi, exact in fp32 for short sums."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(32, 16, generator=g).to(torch.bfloat16).float()
    b = torch.randn(16, 8, generator=g).to(torch.bfloat16).float()
    assert torch.equal(v2.six_products(a, b), a @ b)


# ---------------------- the walks against the JAX kernels ------------------


@pytest.fixture(scope="module")
def mlp(request):
    """Seeded JAX NeRFMLP params (JAX flat list) and the port's flat list."""
    return once_per_run(request, _mlp)


def _mlp():
    m = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS)
    pe, ve = 3 * (1 + 2 * MR), 3 * (1 + 2 * MV)
    params = m.init(jax.random.PRNGKey(2), jnp.zeros((2, pe)),
                    jnp.zeros((2, ve)))
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfm.flatten_params(params, True, DEPTH)]
    jflat = [w[None, :] if w.ndim == 1 else w for w in jflat]
    sd = interop.mlp_state_from_jax(params["params"])
    return jflat, fm.flatten_params(sd, True, DEPTH)


def _as_jax_layout(port_grads):
    return [g.numpy().T if g.ndim == 2 else g.numpy()[None]
            for g in port_grads]


def _assert_grads(got, want, **tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(_as_jax_layout(got), want)):
        np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b),
                                   err_msg=f"weight {i}", **tol)


@pytest.fixture(scope="module")
def bwd_case(request, mlp):
    return once_per_run(request, lambda: _bwd_case(mlp))


def _bwd_case(mlp):
    jflat, flat = mlp
    rs = np.random.RandomState(7)
    n = 300  # not a multiple of the JAX tile
    pts = rs.uniform(-2, 2, (3, n)).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    g = rs.randn(4, n).astype(np.float32)
    want = [np.asarray(x) for x in jv2._bwd_pallas_T(
        jflat, jnp.asarray(pts), jnp.asarray(views), jnp.asarray(g), DEPTH,
        SKIPS, MR, MV, 128, True, jnp.float32)]
    return flat, [torch.from_numpy(x) for x in (pts, views, g)], want


def test_six_product_bwd_walk_matches_jax_bwd_kernel(bwd_case):
    """#2's fp32 walk (packed buffers; the forward's fp32 products, the
    backward's and the dW as six products) against the JAX
    `_bwd_pallas_T` in fp32: the bound the plain and packed fp32 walks
    are held to."""
    flat, (pts, views, g), want = bwd_case
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    got = v2.packed_bwd_reference_T(packed, pts, views, g,
                                    mm=v2.six_products)
    _assert_grads(got, want, **DW_TOL)
    plain = v2.packed_bwd_reference_T(packed, pts, views, g)
    rel = max((torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
              for a, b in zip(got, plain))
    assert rel < 1e-5


@pytest.fixture(scope="module")
def level_case(request, mlp):
    return once_per_run(request, lambda: _level_case(mlp))


def _level_case(mlp):
    jflat, flat = mlp
    rs = np.random.RandomState(3)
    o = rs.randn(N_RAYS, 3).astype(np.float32)
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    z = np.sort(rs.uniform(size=(N_RAYS, SEG)) * 4 + 2, -1).astype(
        np.float32)
    target = rs.uniform(size=(N_RAYS, 3)).astype(np.float32)
    prior = (rs.uniform(size=N_RAYS) * 4 + 2).astype(np.float32)
    crgb = rs.uniform(size=N_RAYS).astype(np.float32)
    cdep = rs.uniform(size=N_RAYS).astype(np.float32)
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dnorm = np.linalg.norm(d, axis=-1).astype(np.float32)
    pts_T = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3).T
    views_T = np.broadcast_to(viewdirs[:, None],
                              (N_RAYS, SEG, 3)).reshape(-1, 3).T
    inputs = dict(pts_T=np.ascontiguousarray(pts_T),
                  views_T=np.ascontiguousarray(views_T), z=z, dn=dnorm,
                  crgb=crgb, tgt=target, cd=cdep, prior=prior)

    def rep(x):
        return jop._rep_row(jnp.asarray(x), SEG)

    out_rows, d_ws = jop.onepass_level_T(
        jflat, jnp.asarray(inputs["pts_T"]), jnp.asarray(inputs["views_T"]),
        jnp.asarray(z.reshape(1, -1)), rep(dnorm), rep(crgb), rep(target),
        rep(cdep), rep(prior), seg=SEG, net_depth=DEPTH, skips=SKIPS,
        multires=MR, multires_views=MV, tile=256, white_bkgd=True,
        interpret=True)
    want = (np.asarray(out_rows), [np.asarray(x) for x in d_ws])
    return flat, {k: torch.from_numpy(np.asarray(v)) for k, v in
                  inputs.items()}, want


def test_six_product_onepass_walk_matches_jax_kernel(level_case):
    """#3's fp32 walk (the packed forward in fp32, compositing, its VJP,
    the packed backward with six-product products and dW) against the JAX
    `onepass_level_T` in fp32: rgb, acc and w at 1e-5, depth at 1e-4, dW
    at the JAX package's bound."""
    flat, x, (want_rows, want_dw) = level_case
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    rows, dw = op.packed_onepass_reference(
        packed, x["pts_T"], x["views_T"], x["z"], x["dn"], x["crgb"],
        x["tgt"], x["cd"], x["prior"], True, mm=v2.six_products)
    got = rows.numpy()
    for sl, tol in ((slice(0, 3), 1e-5), (slice(3, 4), 1e-4),
                    (slice(4, 6), 1e-5)):
        np.testing.assert_allclose(got[sl], want_rows[sl], atol=tol,
                                   rtol=1e-5)
    _assert_grads(dw, want_dw, **DW_TOL)


# ----------------------------- the sources --------------------------------


def c_signature(source: str, symbol: str):
    """(pointer parameters, int parameters) of `extern "C" int symbol(...)`
    in csrc/source, the last pointer (the stream) not counted."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, f"{symbol} is not declared in {source}"
    params = [q.strip() for q in m.group(1).split(",")]
    return (sum("*" in q for q in params) - 1,
            sum(q.startswith("int ") for q in params))


def test_fp32_plans_take_the_level_walk():
    """fp32 #3, #5, #2, #11, #7 and #16 plan through level_plan (the walk
    by shape, the legacy walk past it) and launch with three planes; the
    v1 kernel #14 keeps legacy_level_plan in fp32."""
    for source in ("onepass_level.cu", "onepass_mip_level.cu"):
        one = (CSRC / source).read_text()
        assert "legacy_level_plan<float>" not in one
        assert "mlp::level_plan<mlp::ColMajor, false, T>" in one
        assert "level_launch<T, false, mlp::kPlanes<T>>" in one
        assert "mlp::WMapsN<mlp::kPlanes<T>>" in " ".join(one.split())
    for source in ("fused_mlp_bwd.cu", "fused_mip_bwd.cu"):
        bwd = (CSRC / source).read_text()
        assert "legacy_level_plan" not in bwd and "kWalk" not in bwd
        assert "mlp::level_plan<L, false, T>" in bwd
        assert "level_launch<T, false, mlp::kPlanes<T>>" in bwd
        assert "mlp::WMapsN<mlp::kPlanes<T>>" in " ".join(bwd.split())
    assert "legacy_level_plan<" in (CSRC / "fused_mlp_v1_bwd.cu").read_text()
    walk = (CSRC / "level_train.cuh").read_text()
    assert "return legacy_level_plan<T, V1>(" in walk


def test_entry_points_take_the_planes(monkeypatch):
    """#3's entry point takes w3 after w (16 pointers, 9 ints), #2's and
    #11's too (10 pointers, 7 ints), and the wrappers declare and pass
    them: `op._kernel`'s argtypes, and `v2.PLANE_ENTRIES`."""
    assert c_signature("onepass_level.cu", "onepass_level") == (16, 9)
    for symbol in (v2.BWD_KERNEL, v2.ROW_BWD_KERNEL):
        assert c_signature("fused_mlp_bwd.cu", symbol) == (10, 7)
        assert symbol in v2.PLANE_ENTRIES
    text = (CSRC / "onepass_level.cu").read_text()
    assert "const void* w,\n                             const void* w3," \
        in text
    lib = SimpleNamespace(onepass_level_plan=SimpleNamespace(),
                          onepass_level=SimpleNamespace())
    monkeypatch.setattr(_build, "load", lambda name: lib)
    plan, fn = op._kernel.__wrapped__()
    assert len(fn.argtypes) == 16 + 9 + 1 and len(plan.argtypes) == 9


@pytest.mark.parametrize("tool", ["fp32_walk_ab", "fp32_walk_diag"])
def test_the_measurement_tool_stands_alone(tool):
    """tools/fp32_walk_ab.py, which times the fp32 walk on the card, and
    tools/fp32_walk_diag.py, which holds its arithmetic against fp32 and
    fp64 there, load no jax and nothing of the JAX package (the card's
    machine has neither)."""
    import subprocess
    import sys

    tools = Path(__file__).resolve().parents[1] / "tools"
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'consistentnerf_tpu')); "
            "print('banned:', bad)" % (str(tools), tool))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "banned: []" in proc.stdout
    text = (tools / f"{tool}.py").read_text()
    assert "import jax" not in text and "consistentnerf_tpu." not in text


def test_the_bound_table_needs_no_card():
    """`tools/fp32_walk_ab.py --bounds` prints the two fp32 bounds of
    every kernel row of PERF.md's table with no card: #3's fine level at
    3,489,024 FLOP a point over 67 TFLOP/s and over 989 / 6."""
    import subprocess
    import sys

    tool = Path(__file__).resolve().parents[1] / "tools" / "fp32_walk_ab.py"
    proc = subprocess.run([sys.executable, str(tool), "--bounds"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 15
    fine = next(x for x in lines if x.startswith("#3 fine"))
    assert "40.953 ms (CUDA cores) / 16.646 ms" in fine
