"""The fp32 level walk of the mip kernels #5, #7 and #16 on the CPU: its
arithmetic, its shared memory and the buffers it reads.

In fp32 the one-pass mip level #5 (`csrc/onepass_mip_level.cu`), the mip
weight grads #7 and their row-major twin #16 (`csrc/fused_mip_bwd.cu`)
run `csrc/level_train.cuh`'s fp32 walk, as #2, #3 and #11 do: the
forward on the CUDA cores, the backward's products and the dW as six
bf16 products a fp32 product (`ops/fused_mlp_v2.py::six_products`) on
the weights' three bf16 planes (`PackedMLP.w3`). The mip encoding is 96
columns wide, so the walk keeps its forward's pe tile in the weight ring
beside the second activation tile (`level_train.cuh::pe_in_ring`,
mirrored by `ops/fused_mlp.py::walk_smem_bytes`). Held here: fp32 mip
packs carry the planes and v1 packs none; the walk's shared memory fits a
block at the mip presets' chunks in both layouts, where the carve-up of
the NeRF walk would not, and the bf16 and NeRF fp32 figures stay; the
three entry points take the planes; the packed mip walks computed with
six products agree with the JAX package's fp32 `fused_mip._bwd_pallas_T`
and `fused_onepass.onepass_mip_level_T` (interpret mode) at a small
MipMLP with a skip and a ragged point count. The kernels themselves run
on the card (`tests/test_torch_port_cuda.py`, `chip_smoke.py`).
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from test_torch_port_fp32_walk import c_signature
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "consistentnerf_tpu_torch" / \
    "csrc"
# A small MipMLP with the skip (after layer 4, as every MipMLP has it):
# depth 6, width 32, 4 IPE frequencies, view width 128.
DEPTH, WIDTH, NF = 6, 32, 4
# The JAX package's bound for its kernels' weight grads, and the rows'.
DW_TOL = dict(atol=2e-4, rtol=2e-3)
ROWS_TOL = 1e-5
# Bytes of a block at 768-row chunks (8x256, 16 IPE frequencies / view
# degree 4): the ring 98,304 + 1,024, ve 64 x 40 floats, one fp32
# activation tile 64 x 264, the rows (4 x 64 + 5 x 768 floats), the
# column sums (2 x 8 x 256 floats), and with `row` the staging (9 x 64).
RING = 3 * 4 * 64 * 64 * 2 + 1024
PE_TILE = 4 * 64 * (96 + 8)


def _torch_mip(depth=8, width=256, nf=16, seed=0):
    mlp = MipMLP(net_depth=depth, net_width=width, max_deg_point=nf)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return fmip.flatten_mip_params(mlp, depth)


def _nerf(mr=10):
    mlp = NeRFMLP(input_ch=3 * (1 + 2 * mr))
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    return fm.flatten_params(mlp, True, 8)


# ------------------------------ the planes --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mip_packs_carry_planes_in_fp32(dtype):
    """An fp32 mip pack holds w3 = split3(w), [3, w.numel()] bf16, whose
    base and strides the walk's TMA maps can read; a bf16 pack holds
    none (its walk reads w itself); v1 packs hold none in either type
    (#14 keeps train_block in fp32)."""
    flat = _torch_mip(DEPTH, WIDTH, NF)
    packed = fmip.pack(flat, DEPTH, NF, dtype)
    if dtype == "float32":
        assert packed.w3.shape == (3, packed.w.numel())
        assert packed.w3.dtype == torch.bfloat16
        assert packed.w3.is_contiguous()
        assert torch.equal(packed.w3, v2.split3(packed.w))
        assert torch.equal(packed.w3.float().sum(0), packed.w)
    else:
        assert packed.w3 is None
    v2.check_planes(packed)
    v2.check_tma_weights(packed)
    assert fm.pack_v1(_nerf(4), 8, (4,), 4, 4, dtype).w3 is None


# --------------------------- the shared memory ----------------------------


@pytest.mark.parametrize("row", [False, True])
def test_fp32_mip_walk_fits_a_block_at_the_presets_chunks(row):
    """The fp32 mip walk at 8x256, 16 IPE frequencies and the 768-row
    chunks its plan takes at every mip preset's shapes (#5 at 1024 x 96,
    #7 at 98,304 and 196,608 points, #16 on row-major streams): its pe
    tile in the weight ring, 209,920 B (212,224 with the staging), under
    a block's 232,448 with the static bytes. With the pe tile in its own
    place, as the NeRF encoder's fp32 walk keeps it, the same chunks take
    237,872 B (240,176) and do not fit."""
    packed = fmip.pack(_torch_mip(), 8, 16, "float32")
    got = fm.walk_smem_bytes(packed, 768, row)
    tiles = 4 * 64 * ((32 + 8) + (256 + 8))
    floats = 4 * (4 * 64 + 5 * 768 + 2 * 8 * 256 + (9 * 64 if row else 0))
    assert got == RING + tiles + floats == (212_224 if row else 209_920)
    assert got + fm.K_WALK_STATIC <= fm.SMEM_LIMIT
    own = got + PE_TILE + fm.K_WALK_STATIC
    assert own == (240_176 if row else 237_872) > fm.SMEM_LIMIT
    # The ring holds the forward's second activation tile and pe.
    assert 4 * 64 * (256 + 8) + PE_TILE <= fm.K_WSTAGES * fm.K_WSTAGE


def test_the_other_walks_keep_their_figures():
    """The bf16 walks and the NeRF encoder's fp32 walk keep their
    carve-ups: bf16 mip 218,112 B at 768 rows (two bf16 activation tiles,
    pe in its own place), fp32 NeRF 228,352 (230,656 with the staging),
    bf16 NeRF 212,480 at 576 rows (#14's figure on the card)."""
    mip16 = fmip.pack(_torch_mip(), 8, 16, "bfloat16")
    assert fm.walk_smem_bytes(mip16, 768, False) == 218_112
    nerf32 = v2.pack(_nerf(), 8, (4,), 10, 4, "float32")
    assert fm.walk_smem_bytes(nerf32, 768, False) == 228_352
    assert fm.walk_smem_bytes(nerf32, 768, True) == 230_656
    nerf16 = v2.pack(_nerf(), 8, (4,), 10, 4, "bfloat16")
    assert fm.walk_smem_bytes(nerf16, 576) == 212_480


@pytest.mark.parametrize("nf,in_ring", [(16, True), (18, True),
                                        (19, False)])
def test_pe_moves_into_the_ring_where_it_fits(nf, in_ring):
    """`walk_smem_bytes` follows `level_train.cuh::pe_in_ring`: at width
    256 the ring holds the activation tile (264 floats a row) and pe up to
    120 floats a row (18 frequencies: 108 columns padded to 112, + 8); at
    19 frequencies (128 + 8) pe stays in its own place."""
    packed = fmip.pack(_torch_mip(8, 256, nf), 8, nf, "float32")
    p = v2._pad16(6 * nf)
    own = RING + 4 * 64 * ((p + 8) + (32 + 8) + (256 + 8)) + 4 * (
        4 * 64 + 5 * 768 + 2 * 8 * 256)
    got = fm.walk_smem_bytes(packed, 768, False)
    assert got == (own - 4 * 64 * (p + 8) if in_ring else own)
    assert (64 * (264 + p + 8) * 4 <= fm.K_WSTAGES * fm.K_WSTAGE) == in_ring
    text = (CSRC / "level_train.cuh").read_text()
    assert "inline bool pe_in_ring(const Dims& d)" in text
    assert "return d.ipe && (size_t)M * (d.act_cols() + d.P + 2 * kPad)" in \
        text


# ----------------------------- the sources --------------------------------


def test_entry_points_take_the_planes(monkeypatch):
    """#5's entry point takes w3 after w (20 pointers, 10 ints, 3
    floats), #7's and #16's too (11 pointers, 8 ints); `op._mip_kernel`
    declares them and `v2.PLANE_ENTRIES` names the two weight-grad
    symbols, so `grad_launch` passes the planes."""
    assert c_signature("onepass_mip_level.cu", "onepass_mip_level") == \
        (20, 10)
    text = (CSRC / "onepass_mip_level.cu").read_text()
    assert "const void* w, const void* w3, const void* b, void* out," in text
    for symbol in (fmip.BWD_KERNEL, fmip.ROW_BWD_KERNEL):
        assert c_signature("fused_mip_bwd.cu", symbol) == (11, 8)
        assert symbol in v2.PLANE_ENTRIES
    lib = SimpleNamespace(onepass_mip_level_plan=SimpleNamespace(),
                          onepass_mip_level=SimpleNamespace())
    monkeypatch.setattr(_build, "load", lambda name: lib)
    plan, fn = op._mip_kernel.__wrapped__()
    assert len(fn.argtypes) == 20 + 10 + 3 + 1 and len(plan.argtypes) == 10


@pytest.mark.parametrize("row", [False, True])
def test_weight_grad_launch_passes_the_planes(monkeypatch, row):
    """fp32 #7 / #16 through `grad_launch` with fake entry points and a
    plan of the level walk (slot 8 = 1): a bf16 workspace of the plan's
    size, and w3's pointer right after w's."""
    slots = (4, 3 * 1000, 320, 200_000, 768, 2, 2 * 999, 5, 1)
    calls = []

    def entry(lib, symbol, n_ptr, n_int):
        def fn(*args):
            assert len(args) == n_ptr + n_int + 1
            if symbol.endswith("_plan"):
                for i, v in enumerate(slots):
                    args[-1][i] = v
            else:
                calls.append(args[:n_ptr])
            return 0
        return fn
    monkeypatch.setattr(v2, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    packed = fmip.pack(_torch_mip(DEPTH, WIDTH, NF), DEPTH, NF, "float32")
    gen = torch.Generator().manual_seed(0)
    n = 300
    shape = (n, 3) if row else (3, n)
    streams = [torch.rand(shape, generator=gen) for _ in range(3)]
    g = torch.randn((n, 4) if row else (4, n), generator=gen)
    bufs = []
    real = v2.level_buffers

    def record(*a):
        bufs.append(real(*a))
        return bufs[-1]
    monkeypatch.setattr(v2, "level_buffers", record)
    grads, launched = v2.grad_launch(
        fmip.BWD_KERNEL, fmip.ROW_BWD_KERNEL if row else fmip.BWD_KERNEL,
        packed, streams, g, fmip._cfg_args(packed), row)
    assert launched and len(grads) == len(packed.flat)
    (ws, part, gpart, dw), = bufs
    assert ws.dtype == torch.bfloat16 and ws.numel() == slots[1]
    ptrs, = calls
    want = [t.data_ptr() for t in (*streams, g, packed.w, packed.w3,
                                   packed.b, ws, part, gpart, dw)]
    assert list(ptrs) == want


# ---------------------- the walks against the JAX kernels ------------------


def _mlp():
    """Seeded JAX MipMLP params as the JAX flat list and the port's."""
    m = JaxMipMLP(net_depth=DEPTH, net_width=WIDTH, max_deg_point=NF,
                  disable_normals=True)
    z = jnp.zeros((2, 3))
    params = m.init(jax.random.PRNGKey(4), None, (z, z), z)
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(params,
                                                              DEPTH)]
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = [sd[f"mlp.dense.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}"]
            for i in range(2 * (DEPTH + 4))]
    return jflat, flat


def _streams(n, seed):
    rs = np.random.RandomState(seed)
    means = (rs.rand(3, n) * 3 - 1.5).astype(np.float32)
    covs = (rs.rand(3, n) * 1e-3).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    return means, covs, views


def _assert_grads(got, want, **tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy().T if a.ndim == 2 else a.numpy()
        np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b),
                                   err_msg=f"weight {i}", **tol)


def _rel(got, want):
    return max((torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
               for a, b in zip(got, want))


@pytest.fixture(scope="module")
def bwd_case(request):
    return once_per_run(request, _bwd_case)


def _bwd_case():
    jflat, flat = _mlp()
    n = 300  # not a multiple of the JAX tile or of a 64-point sub-tile
    m, c, v = _streams(n, 2)
    g = np.random.RandomState(3).randn(4, n).astype(np.float32)
    want = [np.asarray(x) for x in jfmip._bwd_pallas_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v),
        jnp.asarray(g), DEPTH, 4, NF, 4, 128, True, jnp.float32)]
    return flat, [torch.from_numpy(x) for x in (m, c, v, g)], want


def test_six_product_mip_bwd_walk_matches_jax_bwd_kernel(bwd_case):
    """#7's (and #16's) fp32 walk on its packed buffers, the backward's
    products and the dW as six products, against the JAX `_bwd_pallas_T`
    in fp32, and within 1e-5 of the same walk with fp32 matmuls."""
    flat, (m, c, v, g), want = bwd_case
    packed = fmip.pack(flat, DEPTH, NF, "float32")
    got = v2.packed_bwd_reference_T(packed, m, v, g, c, mm=v2.six_products)
    _assert_grads(got, want, **DW_TOL)
    assert _rel(got, v2.packed_bwd_reference_T(packed, m, v, g, c)) < 1e-5
    # The row-major twin reads the same points as [N, 3] streams and an
    # [N, 4] cotangent: its plain version is #7's on the transposes.
    row = fmip.bwd(flat, m.T.contiguous(), c.T.contiguous(),
                   v.T.contiguous(), g.T.contiguous(), DEPTH, NF, "float32")
    assert _rel(got, row) < 1e-4


@pytest.fixture(scope="module")
def level_case(request):
    return once_per_run(request, _level_case)


def _level_case():
    jflat, flat = _mlp()
    n_rays, seg = 13, 16  # 208 points: three 64-point sub-tiles and 16
    rs = np.random.RandomState(5)
    m, c, v = _streams(n_rays * seg, 5)
    v = np.repeat(v[:, :n_rays], seg, 1)
    t = np.sort(rs.rand(n_rays, seg + 1) * 4 + 2, -1).astype(np.float32)
    dn = (0.5 + rs.rand(n_rays)).astype(np.float32)
    rows = dict(
        tmid=0.5 * (t[:, 1:] + t[:, :-1]),
        delta=(t[:, 1:] - t[:, :-1]) * dn[:, None],
        tlo=t[:, 0], thi=t[:, -1],
        crgb=rs.rand(n_rays).astype(np.float32),
        tgt=rs.rand(n_rays, 3).astype(np.float32),
        cd=rs.rand(n_rays).astype(np.float32),
        prior=(rs.rand(n_rays) * 4 + 2).astype(np.float32),
        noise=rs.randn(n_rays, seg).astype(np.float32))

    def rep(x):
        x = np.asarray(x, np.float32)
        x = x[:, None] if x.ndim == 1 else x
        return jnp.asarray(np.repeat(x.T, seg, 1))

    out_rows, dws = jop.onepass_mip_level_T(
        jflat, jnp.asarray(m), jnp.asarray(c), jnp.asarray(v),
        jnp.asarray(rows["tmid"].reshape(1, -1)),
        jnp.asarray(rows["delta"].reshape(1, -1)), rep(rows["tlo"]),
        rep(rows["thi"]), rep(rows["crgb"]), rep(rows["tgt"]),
        rep(rows["cd"]), rep(rows["prior"]),
        jnp.asarray(rows["noise"].reshape(1, -1)), seg=seg,
        net_depth=DEPTH, num_freqs=NF, white_bkgd=True, interpret=True,
        tile=256, compute_dtype=jnp.float32)
    port = {k: torch.from_numpy(x) for k, x in rows.items()}
    return flat, [torch.from_numpy(x) for x in (m, c, v)], port, (
        np.asarray(out_rows), [np.asarray(x) for x in dws])


def test_six_product_mip_level_walk_matches_jax_kernel(level_case):
    """#5's fp32 walk (the packed forward in fp32, the mip compositing and
    its VJP with a density-noise row, the packed backward with
    six-product products and dW) against the JAX `onepass_mip_level_T`
    in fp32: rows at 1e-5, dW at the JAX package's bound."""
    flat, (m, c, v), p, (want_rows, want_dw) = level_case
    packed = fmip.pack(flat, DEPTH, NF, "float32")
    args = (p["tmid"], p["delta"], p["tlo"], p["thi"], p["crgb"], p["tgt"],
            p["cd"], p["prior"], p["noise"])
    rows, dw = op.packed_onepass_mip_reference(
        packed, m, c, v, *args, white_bkgd=True, mm=v2.six_products)
    np.testing.assert_allclose(rows.numpy(), want_rows, atol=ROWS_TOL,
                               rtol=ROWS_TOL)
    _assert_grads(dw, want_dw, **DW_TOL)
    plain = op.packed_onepass_mip_reference(packed, m, c, v, *args,
                                            white_bkgd=True)[1]
    assert _rel(dw, plain) < 1e-5
