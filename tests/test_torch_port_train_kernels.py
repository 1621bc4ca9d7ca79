"""The train kernels' plain versions and packed walks vs the JAX package.

Kernel #2 (`ops/fused_mlp_v2.py::bwd_T`, the MLP weight grads) is held
against the JAX `_bwd_pallas_T`, and kernel #3
(`ops/fused_onepass.py::onepass_level_T`, the one-pass level) against the
JAX `onepass_level_T`, both in interpret mode, at depth 4, width 32, skip
after layer 2, multires 4 / 2. On the CPU the port's wrappers run the
plain versions (autograd through `_mlp_body`); the packed walks follow the
CUDA kernels' buffers and rounding, so their layout is proved here before
any card runs them. Each JAX reference is computed once per module.
"""

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
from consistentnerf_tpu_torch.models.mlp import NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op

DEPTH, WIDTH, SKIPS, MR, MV = 4, 32, (2,), 4, 2
N_RAYS, SEG = 12, 16
# The JAX package's own bound for its kernels' weight grads.
DW_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mlp():
    """Seeded JAX NeRFMLP params (JAX flat list) and the port's flat list."""
    m = JaxNeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS)
    pe, ve = 3 * (1 + 2 * MR), 3 * (1 + 2 * MV)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, pe)),
                    jnp.zeros((2, ve)))
    params = jax.tree_util.tree_map(np.asarray, params)
    jflat = [jnp.asarray(w) for w in jfm.flatten_params(params, True, DEPTH)]
    jflat = [w[None, :] if w.ndim == 1 else w for w in jflat]
    sd = interop.mlp_state_from_jax(params["params"])
    flat = fm.flatten_params(sd, True, DEPTH)
    return jflat, flat


def _as_jax_layout(port_grads):
    """Port (torch [out, in], biases [C]) -> JAX ([in, out], [1, C])."""
    return [g.numpy().T if g.ndim == 2 else g.numpy()[None]
            for g in port_grads]


def _assert_grads(got, want, **tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(_as_jax_layout(got), want)):
        np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b),
                                   err_msg=f"weight {i}", **tol)


# ----------------------------- kernel #2 ---------------------------------


@pytest.fixture(scope="module")
def bwd_case(mlp):
    jflat, flat = mlp
    rs = np.random.RandomState(4)
    n = 300  # not a multiple of the JAX tile
    pts = rs.uniform(-2, 2, (3, n)).astype(np.float32)
    views = rs.randn(3, n).astype(np.float32)
    views /= np.linalg.norm(views, axis=0, keepdims=True)
    g = rs.randn(4, n).astype(np.float32)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        want[dt] = [np.asarray(x) for x in jv2._bwd_pallas_T(
            jflat, jnp.asarray(pts), jnp.asarray(views), jnp.asarray(g),
            DEPTH, SKIPS, MR, MV, 128, True, dt)]
    return flat, [torch.from_numpy(x) for x in (pts, views, g)], want


def test_plain_bwd_matches_jax_bwd_kernel(bwd_case):
    flat, (pts, views, g), want = bwd_case
    got = v2.bwd_T(flat, pts, views, g, DEPTH, SKIPS, MR, MV, "float32")
    _assert_grads(got, want[jnp.float32], **DW_TOL)
    assert [x.shape for x in got] == [w.shape for w in flat]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_bwd_walk_matches_jax_bwd_kernel(bwd_case, dtype):
    """The CUDA kernel's walk over its packed buffers, unpacked, equals
    the JAX kernel: layout, unpacking and (at bf16) rounding points."""
    flat, (pts, views, g), want = bwd_case
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, dtype)
    got = v2.packed_bwd_reference_T(packed, pts, views, g)
    if dtype == "float32":
        _assert_grads(got, want[jnp.float32], **DW_TOL)
    else:
        # Same rounding points as the JAX kernel; the fp32 sums run in
        # another order, which can flip a bf16 rounding of a gradient.
        for a, b in zip(_as_jax_layout(got), want[jnp.bfloat16]):
            b = np.asarray(b).reshape(a.shape)
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).mean() + 1e-6


def test_grad_numel_and_unpack_shapes(mlp):
    _, flat = mlp
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    n_w, n_b = v2.grad_numel(packed)
    assert n_w == packed.w.numel() and n_b == packed.b.numel()
    dw = torch.arange(n_w, dtype=torch.float32)
    db = torch.arange(n_b, dtype=torch.float32)
    got = v2.unpack_grads(packed, dw, db)
    assert [x.shape for x in got] == [w.shape for w in flat]
    # Packing the unpacked grads as weights gives the packed grads back
    # wherever the packing holds real rows (padding rows are zero).
    repacked = v2.pack(got, DEPTH, SKIPS, MR, MV, "float32")
    keep = packed.w != 0
    assert torch.equal(repacked.w[keep], dw[keep])
    assert torch.equal(repacked.b, db)


def test_train_op_autograd_matches_plain_bwd(bwd_case):
    """fused_mlp_v2_train_T: forward fwd_T, backward bwd_T (CPU: plain)."""
    flat, (pts, views, g), _ = bwd_case
    leaves = [w.clone().requires_grad_() for w in flat]
    raw = v2.fused_mlp_v2_train_T(leaves, pts, views, DEPTH, SKIPS, MR, MV,
                                  "float32")
    want_raw = v2.plain_fwd_T(flat, pts, views, DEPTH, SKIPS, MR, MV,
                              "float32")
    assert torch.equal(raw.detach(), want_raw)
    (raw * g).sum().backward()
    want = v2.plain_bwd_T(flat, pts, views, g, DEPTH, SKIPS, MR, MV,
                          "float32")
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=1e-6, rtol=1e-5)


def test_bwd_wrapper_on_cpu_launches_nothing(bwd_case):
    flat, (pts, views, g), _ = bwd_case
    before = v2.bwd_launches
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    got = v2.bwd_T(packed, pts, views, g, DEPTH, SKIPS, MR, MV, "float32")
    want = v2.plain_bwd_T(flat, pts, views, g, DEPTH, SKIPS, MR, MV,
                          "float32")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert v2.bwd_launches == before
    with pytest.raises(ValueError, match="another config"):
        v2.bwd_T(packed, pts, views, g, DEPTH, SKIPS, MR, MV, "bfloat16")


# ----------------------------- kernel #3 ---------------------------------


@pytest.fixture(scope="module")
def level_case(mlp):
    """The inputs of tests/test_fused_onepass.py's level oracle, made with
    numpy, and the JAX kernel's outputs on them."""
    jflat, flat = mlp
    rs = np.random.RandomState(1)
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


def _assert_rows(got, want):
    got = got.numpy()
    # rgb, acc and w at 1e-5, depth at 1e-4 (the JAX package's bounds).
    for rows, tol in ((slice(0, 3), 1e-5), (slice(3, 4), 1e-4),
                      (slice(4, 6), 1e-5)):
        np.testing.assert_allclose(got[rows], want[rows], atol=tol,
                                   rtol=1e-5)


def test_plain_onepass_level_matches_jax_kernel(level_case):
    flat, x, (want_rows, want_dw) = level_case

    def rep(v):
        return op._rep_row(v, SEG)

    rows, dw = op.onepass_level_T(
        flat, x["pts_T"], x["views_T"], x["z"].reshape(1, -1), rep(x["dn"]),
        rep(x["crgb"]), rep(x["tgt"]), rep(x["cd"]), rep(x["prior"]),
        seg=SEG, net_depth=DEPTH, skips=SKIPS, multires=MR,
        multires_views=MV, white_bkgd=True)
    assert rows.shape == (6, N_RAYS * SEG)
    _assert_rows(rows, want_rows)
    _assert_grads(dw, want_dw, **DW_TOL)


def test_packed_onepass_walk_matches_jax_kernel(level_case):
    """The one-pass kernel's walk: packed forward, the kernel's
    compositing and its explicit VJP, packed backward, unpacking."""
    flat, x, (want_rows, want_dw) = level_case
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    rows, dw = op.packed_onepass_reference(
        packed, x["pts_T"], x["views_T"], x["z"], x["dn"], x["crgb"],
        x["tgt"], x["cd"], x["prior"], True)
    _assert_rows(rows, want_rows)
    _assert_grads(dw, want_dw, **DW_TOL)


def test_composite_bwd_is_the_vjp_of_composite_fwd():
    g = torch.Generator().manual_seed(5)
    raw = torch.randn(4, 5, 9, generator=g, dtype=torch.float64)
    z = torch.sort(torch.rand(5, 9, generator=g, dtype=torch.float64) * 4
                   + 2, -1).values
    dn = torch.rand(5, generator=g, dtype=torch.float64) + 0.5
    d_rgb = torch.randn(5, 3, generator=g, dtype=torch.float64)
    d_depth = torch.randn(5, generator=g, dtype=torch.float64)
    for white in (False, True):
        r = raw.clone().requires_grad_()
        rgb, depth, _, _, saved = op._composite_fwd(r, z, dn, white)
        (rgb * d_rgb).sum().add((depth * d_depth).sum()).backward()
        got = op._composite_bwd(d_rgb, d_depth, saved, white)
        torch.testing.assert_close(got, r.grad, atol=1e-10, rtol=1e-9)


def test_onepass_wrapper_on_cpu_launches_nothing(level_case):
    flat, x, _ = level_case
    before = op.launches
    kw = dict(net_depth=DEPTH, skips=SKIPS, multires=MR, multires_views=MV,
              white_bkgd=True)
    args = (x["pts_T"], x["views_T"], x["z"], x["dn"], x["crgb"], x["tgt"],
            x["cd"], x["prior"])
    rows, dw = op.onepass_level(flat, *args, **kw)
    rows2, dw2 = op.plain_onepass_level(flat, *args,
                                        compute_dtype=torch.float32, **kw)
    assert torch.equal(rows, rows2)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw2))
    assert op.launches == before
    with pytest.raises(ValueError, match="whole rays"):
        op.onepass_level_T(flat, x["pts_T"][:, :-1], x["views_T"][:, :-1],
                           *[torch.zeros(1, N_RAYS * SEG - 1)] * 2,
                           torch.zeros(1, 1), torch.zeros(3, 1),
                           torch.zeros(1, 1), torch.zeros(1, 1), seg=SEG)


def test_interop_grad_maps_cover_every_parameter(mlp):
    _, flat = mlp
    port = NeRFMLP(net_depth=DEPTH, net_width=WIDTH, skips=SKIPS,
                   input_ch=3 * (1 + 2 * MR),
                   input_ch_views=3 * (1 + 2 * MV))
    grads = [torch.full_like(w, float(i)) for i, w in enumerate(flat)]
    named = op._grad_branch_dict(grads, port, DEPTH)
    assert set(named) == {k for k, _ in port.named_parameters()}
    assert torch.equal(named["pts_linears.1.bias"], grads[3])
    assert torch.equal(named["temp_rgb"], torch.zeros(1))
    interop.add_flat_grads(port, grads, DEPTH)
    interop.add_flat_grads(port, grads, DEPTH)
    assert torch.equal(port.rgb_linear.weight.grad, 2 * grads[-2])
