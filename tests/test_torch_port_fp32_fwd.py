"""The fp32 forward walk of #1 and #6 (`csrc/fwd_f32.cuh`) on the CPU: its
shared memory, the entry points' arguments and the plain fp32 forwards at
the presets' encodings.

In fp32 at widths 64-256 the forwards #1 / #6 and their row-major twins
#10 / #15 (and #12 / #13 at #1's shapes) run a persistent walk on the CUDA
cores that keeps the old walk's (`mlp_fwd.cuh::fwd_tile`) bits. Held here:
the Python mirror of its shared memory (`fused_mlp.fwd_walk_smem_bytes`)
fits a block at the presets' shapes (NeRFMLP 8x256 at multires 10 / 4,
MipMLP 8x256 at 16 IPE frequencies / view degree 4), and the bf16 walk's
figures stay what they were; the wrappers hand the fp32 entry points the
streams, the packed fp32 weights and the config, and refuse weights that
its bulk copies cannot read; the plain fp32 #1 / #6, which the card gates
hold the kernels to, agree with the JAX package's `_fwd_pallas_T` run in
interpret mode at those encodings (the IPE's arguments far past 100 pi).
The kernels themselves run on the card (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import MipMLP as JaxMipMLP
from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.ops import fused_mip as jfmip
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_v2 as jv2
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from test_torch_port_fp32_walk import c_signature
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

# The presets' encodings at a narrow trunk: depth 8 with the skip after
# layer 4, width 64 (the walk's narrowest), 200 points (a JAX tile of 128
# and a ragged one).
DEPTH, WIDTH, SKIPS, MR, MV, NF, N = 8, 64, (4,), 10, 4, 16, 200
# max |port - JAX| / mean |JAX|: both fp32, differing in the order of
# their sums (the card gates' fp32 bound).
FP32_TOL = 1e-4


def _nerf_pack(dtype, width=256, v1=False):
    mlp = NeRFMLP(net_depth=8, net_width=width)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    pack = fm.pack_v1 if v1 else v2.pack
    return pack(fm.flatten_params(mlp), 8, (4,), 10, 4, dtype)


def _mip_pack(dtype, width=256):
    mlp = MipMLP(net_depth=8, net_width=width, max_deg_point=16)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    return fmip.pack(fmip.flatten_mip_params(mlp, 8), 8, 16, dtype)


# ----------------------------- shared memory -------------------------------


@pytest.mark.parametrize("kind, want", [
    # ring 4 x 16 x 256 floats, the activation tile 256 x 68 floats, two
    # pe buffers (64 or 96 rows), ve 32 rows, the head weights, 14 barriers.
    ("nerf", (181_360, 4, 2)), ("mip", (198_768, 4, 2))])
def test_fp32_walk_fits_a_block_at_the_presets_shapes(kind, want):
    """The fp32 walk keeps two pe buffers and a 4-slot ring at both
    presets' shapes, within the 232,448 bytes an H100 block holds; the
    streams' layout (#1 / #10, #6 / #15) does not change the figure, and
    the plan is the same for both."""
    packed = _nerf_pack("float32") if kind == "nerf" else _mip_pack(
        "float32")
    assert fm.fwd_walk_smem_bytes(packed) == want
    assert want[0] <= fm.SMEM_LIMIT == 232_448
    ring, act = 4 * 16 * 256 * 4, 256 * 68 * 4
    pe = 2 * (64 if kind == "nerf" else 96) * 68 * 4
    assert want[0] == ring + act + pe + 32 * 68 * 4 + 4 * 256 + 12 * 128 \
        + 14 * 8


@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_fp32_walk_fits_at_every_width(width):
    """Every width the walk takes keeps two pe buffers and 4 ring slots;
    the MipMLP's 128-wide view layer sets the tile's rows at widths 64 and
    128."""
    for packed in (_nerf_pack("float32", width),
                   _mip_pack("float32", width)):
        smem, stages, npe = fm.fwd_walk_smem_bytes(packed)
        assert smem <= fm.SMEM_LIMIT and (stages, npe) == (4, 2)
    rows = max(width, 128)
    assert fm.fwd_walk_smem_bytes(_mip_pack("float32", width))[0] == (
        4 * 16 * rows * 4 + rows * 68 * 4 + 2 * 96 * 68 * 4 + 32 * 68 * 4
        + 4 * width + 12 * 128 + 14 * 8)


@pytest.mark.parametrize("kind, want", [("nerf", (225_360, 3, 2)),
                                        ("mip", (225_344, 2, 2))])
def test_bf16_walk_figures_are_unchanged(kind, want):
    """The bf16 Hopper walk's shared memory, ring and pe buffers at the
    presets' shapes: the figures its plans logged before the fp32 walk
    (a 3-slot ring for the NeRFMLP, 2 slots beside the mip's 96-column pe
    buffers)."""
    packed = _nerf_pack("bfloat16") if kind == "nerf" else _mip_pack(
        "bfloat16")
    assert fm.fwd_walk_smem_bytes(packed) == want


# ------------------------------ entry points -------------------------------


def _fake_entries(monkeypatch):
    calls = []

    def entry(lib, symbol, n_ptr, n_int):
        def fn(*args):
            assert len(args) == n_ptr + n_int + 1
            calls.append((lib, symbol, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return fn
    monkeypatch.setattr(v2, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("row", [False, True])
def test_nerf_entries_take_the_fp32_pack(monkeypatch, row):
    """#1 / #10 through `fwd_launch` and #12 through `v1_forward` with
    fake entry points: the streams, the packed fp32 weights and biases and
    the output, then n and the config with bf16 = 0 (and v1's out_ch); the
    C entries declare as many."""
    assert c_signature("fused_mlp_fwd.cu", v2.KERNEL) == (5, 7)
    assert c_signature("fused_mlp_fwd.cu", v2.ROW_KERNEL) == (5, 7)
    assert c_signature("fused_mlp_v1_fwd.cu", fm.KERNEL) == (5, 8)
    calls = _fake_entries(monkeypatch)
    n = 300
    g = torch.Generator().manual_seed(0)
    shape = (n, 3) if row else (3, n)
    pts, views = (torch.rand(shape, generator=g) for _ in range(2))
    packed = _nerf_pack("float32", 128)
    out, launched = v2.fwd_launch(v2.KERNEL, v2.ROW_KERNEL if row else
                                  v2.KERNEL, packed, pts, views, row)
    assert launched and out.shape == ((n, 4) if row else (4, n))
    lib, symbol, ptrs, ints = calls[-1]
    assert (lib, symbol) == (v2.KERNEL, v2.ROW_KERNEL if row else v2.KERNEL)
    assert ptrs == tuple(t.data_ptr() for t in (pts, views, packed.w,
                                                packed.b, out))
    assert ints == (n, 8, 128, 1 << 4, 10, 4, 0)
    if row:
        packed1 = _nerf_pack("float32", 128, v1=True)
        out1, launched = fm.v1_forward(packed1, pts, views)
        lib, symbol, ptrs, ints = calls[-1]
        assert launched and (lib, symbol) == (fm.KERNEL, fm.KERNEL)
        assert ptrs[2:4] == (packed1.w.data_ptr(), packed1.b.data_ptr())
        assert ints == (n, 8, 128, 1 << 4, 10, 4, 0, 0)


@pytest.mark.parametrize("row", [False, True])
def test_mip_entries_take_the_fp32_pack(monkeypatch, row):
    """#6 / #15 through `fused_mip.fwd_launch` with fake entry points: the
    means, covs and views, the packed fp32 weights and biases and the
    output, then n and the config (view width 128, 16 frequencies, view
    degree 4, bf16 = 0); no launch for 0 points."""
    for symbol in (fmip.KERNEL, fmip.ROW_KERNEL):
        assert c_signature("fused_mip_fwd.cu", symbol) == (6, 8)
    calls = _fake_entries(monkeypatch)
    n = 300
    g = torch.Generator().manual_seed(0)
    shape = (n, 3) if row else (3, n)
    streams = [torch.rand(shape, generator=g) for _ in range(3)]
    packed = _mip_pack("float32", 64)
    out, launched = fmip.fwd_launch(packed, *streams, row)
    lib, symbol, ptrs, ints = calls[-1]
    assert launched and (lib, symbol) == (
        fmip.KERNEL, fmip.ROW_KERNEL if row else fmip.KERNEL)
    assert ptrs == tuple(t.data_ptr() for t in (*streams, packed.w,
                                                packed.b, out))
    assert ints == (n, 8, 64, 128, 1 << 4, 16, 4, 0)
    empty = [torch.zeros((0, 3) if row else (3, 0)) for _ in range(3)]
    assert fmip.fwd_launch(packed, *empty, row)[1] is False
    assert len(calls) == 1


def test_wrappers_refuse_fp32_weights_the_bulk_copies_cannot_read(
        monkeypatch):
    """The fp32 walk copies whole slabs of the packed weights: a base that
    is not 16-byte aligned raises before any launch, for #1 and #6."""
    calls = _fake_entries(monkeypatch)

    def shifted(packed):
        buf = torch.empty(packed.w.numel() + 1)
        buf[1:].copy_(packed.w)
        return dataclasses.replace(packed, w=buf[1:])

    bad = shifted(_nerf_pack("float32", 64))
    assert bad.w.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        v2.fwd_launch(v2.KERNEL, v2.KERNEL, bad, torch.rand(3, 10),
                      torch.rand(3, 10), False)
    with pytest.raises(ValueError, match="aligned"):
        fmip.fwd_launch(shifted(_mip_pack("float32", 64)),
                        *(torch.rand(3, 10) for _ in range(3)), False)
    assert not calls


def test_the_encoder_check_entry_is_declared():
    """`fwd_f32_encode_check` (the card's check that the fp32 walk's
    encoders give fwd_tile's bits) takes three streams and the output, n,
    the two degrees and the IPE switch."""
    assert c_signature("fused_mlp_fwd.cu", "fwd_f32_encode_check") == (4, 4)


# ------------------------- plain fp32 against JAX --------------------------


@pytest.fixture(scope="module")
def nerf_case(request):
    return once_per_run(request, _nerf_case)


def _nerf_case():
    mlp = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS)
    params = mlp.init(jax.random.PRNGKey(1), jnp.zeros((2, 3 + 6 * MR)),
                      jnp.zeros((2, 3 + 6 * MV)))
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [w[None, :] if w.ndim == 1 else w
             for w in jfm.flatten_params(params, True, DEPTH)]
    rs = np.random.RandomState(7)
    pts = rs.uniform(-2, 2, (3, N)).astype(np.float32)
    views = rs.randn(3, N).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    want = np.asarray(jv2._fwd_pallas_T(
        [jnp.asarray(w) for w in jflat], jnp.asarray(pts),
        jnp.asarray(views), DEPTH, SKIPS, MR, MV, 128, True, jnp.float32))
    sd = interop.mlp_state_from_jax(params["params"])
    return {k: np.asarray(v) for k, v in sd.items()}, pts, views, want


@pytest.fixture(scope="module")
def mip_case(request):
    return once_per_run(request, _mip_case)


def _mip_case():
    m = JaxMipMLP(net_depth=DEPTH, net_width=WIDTH, max_deg_point=NF,
                  disable_normals=True)
    z = jnp.zeros((2, 3))
    params = jax.tree_util.tree_map(
        np.asarray, m.init(jax.random.PRNGKey(1), None, (z, z), z))
    jflat = [jnp.asarray(w) for w in jfmip.flatten_mip_params(params,
                                                              DEPTH)]
    rs = np.random.RandomState(7)
    # Means up to 6 in magnitude: at 16 frequencies the sines' arguments
    # reach 2^15 * 6, far past the 100 pi where safe_sin reduces them.
    means = rs.uniform(-6, 6, (3, N)).astype(np.float32)
    covs = (rs.rand(3, N) * 1e-3).astype(np.float32)
    views = rs.randn(3, N).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    want = np.asarray(jfmip._fwd_pallas_T(
        jflat, jnp.asarray(means), jnp.asarray(covs), jnp.asarray(views),
        DEPTH, 4, NF, 4, 128, True, jnp.float32))
    sd = interop.mip_params_from_jax({"params": {"MipMLP_0":
                                                 params["params"]}})
    flat = [np.asarray(sd[f"mlp.dense.{i // 2}."
                          f"{'weight' if i % 2 == 0 else 'bias'}"])
            for i in range(2 * (DEPTH + 4))]
    return flat, (means, covs, views), want


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).mean())


def test_plain_fp32_nerf_forward_matches_jax_at_the_presets_encoding(
        nerf_case):
    """#1's plain fp32 version and the packed walk (the kernel's layout)
    at multires 10 / 4 against `_fwd_pallas_T` in interpret mode."""
    sd, pts, views, want = nerf_case
    flat = fm.flatten_params({k: torch.from_numpy(v) for k, v in sd.items()},
                             True, DEPTH)
    p, v = torch.from_numpy(pts), torch.from_numpy(views)
    got = v2.fwd_T(flat, p, v, DEPTH, SKIPS, MR, MV, "float32")
    assert got.shape == want.shape and _rel(got.numpy(), want) < FP32_TOL
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    walk = v2.packed_reference_T(packed, p, v)
    assert _rel(walk.numpy(), want) < FP32_TOL


def test_plain_fp32_mip_forward_matches_jax_at_the_presets_encoding(
        mip_case):
    """#6's plain fp32 version and the packed walk at 16 IPE frequencies
    and view degree 4 against `_fwd_pallas_T` in interpret mode."""
    flat, streams, want = mip_case
    flat = [torch.from_numpy(w) for w in flat]
    m, c, v = (torch.from_numpy(x) for x in streams)
    got = fmip.fwd_T(flat, m, c, v, DEPTH, NF, "float32")
    assert got.shape == want.shape and _rel(got.numpy(), want) < FP32_TOL
    packed = fmip.pack(flat, DEPTH, NF, "float32")
    walk = v2.packed_reference_T(packed, m, v, c)
    assert _rel(walk.numpy(), want) < FP32_TOL


# ----------------------------- the phase split ------------------------------


def _phase_split():
    import sys
    from pathlib import Path

    tools = Path(__file__).resolve().parents[1] / "tools"
    sys.path.insert(0, str(tools))
    import torch_phase_split as tps

    return tps, tools.parent / "consistentnerf_tpu_torch" / "csrc"


def test_the_fp32_phase_split_guards_the_fp32_walks_heads():
    """`tools/torch_phase_split.py fwd32` cuts the fp32 walk's two heads
    (in `fwd_f32.cuh`) and the encoders' feature computations (FhEnc, in
    `fwd_hopper.cuh`), each guard closing right after its region, and
    leaves every other header as committed; both forward sources include
    the fp32 walk."""
    tps, csrc = _phase_split()
    out = tps.patched_f32_sources(csrc)
    f32 = out[tps.F32_HEADER]
    assert f32.count("#ifndef PHASE_NO_HEADS") == 2
    for first, last, macro, count in tps.F32_REGIONS:
        assert f32.count(f"#ifndef {macro}\n{first}\n") == count
        assert f32.count(f"{last}\n#endif\n") == count
    assert out[tps.FWD_HEADER].count("#ifndef PHASE_NO_ENCODE") == 3
    for header in csrc.glob("*.cuh"):
        if header.name not in (tps.FWD_HEADER, tps.F32_HEADER):
            assert out[header.name] == header.read_text()
    for name in tps.FWD_SOURCES:
        assert f'#include "{tps.F32_HEADER}"' in out[name]


@pytest.mark.parametrize("region", range(2))
@pytest.mark.parametrize("end", [0, 1])
def test_a_missing_fp32_anchor_fails_the_patch(region, end):
    tps, csrc = _phase_split()
    text = (csrc / tps.F32_HEADER).read_text()
    anchor = tps.F32_REGIONS[region][end] + "\n"
    with pytest.raises(ValueError, match="occurs"):
        tps.patched_fwd_header(text.replace(anchor, "", 1), tps.F32_REGIONS,
                               tps.F32_HEADER)


def test_the_fp32_variants_nest():
    """full, then without the heads, then without the heads and the
    encoding: each cuts what the one before it cut and one phase more."""
    tps, _ = _phase_split()
    flags = [tps.F32_VARIANTS[v] for v in ("full", "no_heads", "no_encode")]
    assert [len(f) for f in flags] == [0, 1, 2]
    assert set(flags[1]) < set(flags[2])
