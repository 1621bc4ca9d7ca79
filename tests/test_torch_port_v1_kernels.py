"""The v1 kernels' plain versions, packing and ops vs the JAX package.

Kernel #12 (`ops/fused_mlp.py::fused_mlp`, the v1 forward on [N, 3]
streams) is held against the JAX `fused_mlp`, kernel #13
(`ops/fused_mlp_train.py::forward`) against the JAX `_fwd_pallas`, kernel
#14 (`backward`, the weight grads) against the grads of the JAX
`fused_mlp_train`, and the ops `fused_mlp_train` / `hybrid_mlp_train`
against the JAX ops of those names. The JAX kernels run in interpret mode;
on the CPU the port's wrappers run the plain versions, and the v1 packing
is held by the packed walks (`fused_mlp_v2.packed_reference_T`,
`packed_bwd_reference_T`), which read the buffers as the kernels do.

The cases are the shapes v1 takes beyond the v2 kernels: a skip into the
heads (depth 2 with the skip after layer 1, as the JAX package's own test
of the v1 kernel runs it), `use_viewdirs=False` (#12 only), and
multires 21 (past the TPU v2 kernel's 20-frequency register), beside an
ordinary skip (depth 4, skip after layer 2). Tolerances: forward fp32
1e-5; dW at the row-major tests' `DW_TOL`; bf16 max |port - JAX| /
mean |JAX| < 2e-2, the row-major tests' bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.models.mlp import NeRFMLP as JaxNeRFMLP
from consistentnerf_tpu.ops import fused_mlp as jfm
from consistentnerf_tpu.ops import fused_mlp_train as jfmt
from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

WIDTH = 32
# id -> (depth, skips, multires, multires_views)
CASES = {"skip_heads": (2, (1,), 4, 2), "multires21": (2, (1,), 21, 2),
         "mid_skip": (4, (2,), 4, 2)}
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
DW_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = 2e-2
OUTPUT_CH = 5  # the reference's output_ch with fine sampling


def _jax_layout(port_grads):
    """Port (torch [out, in], biases [C]) -> JAX ([in, out], flat)."""
    return [g.numpy().T if g.ndim == 2 else g.numpy() for g in port_grads]


def _bf16_close(got, want):
    want = np.asarray(want).reshape(got.shape)
    return np.abs(got - want).max() <= BF16_TOL * np.abs(want).mean() + 1e-6


def _params(depth, skips, mr, mv, use_viewdirs):
    """Seeded NeRFMLP weights (biases made non-zero) in both layouts."""
    m = JaxNeRFMLP(net_depth=depth, net_width=WIDTH, skips=skips,
                   use_viewdirs=use_viewdirs, output_ch=OUTPUT_CH)
    pe, ve = 3 * (1 + 2 * mr), 3 * (1 + 2 * mv)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, pe)),
                    jnp.zeros((2, ve)) if use_viewdirs else None)
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(x.dtype),
        params)
    flat = fm.flatten_params(interop.mlp_state_from_jax(params["params"]),
                             use_viewdirs, depth)
    return params, flat


def _streams(n=300, seed=4):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    views = rs.randn(n, 3).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    g = rs.randn(n, 4).astype(np.float32)
    return pts, views, g


@pytest.fixture(scope="module", params=list(CASES))
def v1_case(request):
    """Weights, streams, a cotangent, and the JAX v1 kernels' outputs and
    grads (fp32 and bf16), once a run."""
    return once_per_run(request, lambda: _v1_case(request.param))


def _v1_case(case):
    depth, skips, mr, mv = CASES[case]
    params, flat = _params(depth, skips, mr, mv, True)
    jflat = [jnp.asarray(w) for w in jfm.flatten_params(params, True, depth)]
    jflat = tuple(w[None, :] if w.ndim == 1 else w for w in jflat)
    pts, views, g = _streams()
    ins = (jnp.asarray(pts), jnp.asarray(views))
    args = (depth, skips, mr, mv, 128, True)
    want = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        want[name] = {"fwd": np.asarray(jfmt._fwd_pallas(jflat, *ins, *args,
                                                         dt))}
        for op_name, op in (("train", jfmt.fused_mlp_train),
                            ("hybrid", jfmt.hybrid_mlp_train)):
            raw, vjp = jax.vjp(lambda w, op=op, dt=dt: op(w, *ins, *args, dt),
                               jflat)
            want[name][op_name] = (np.asarray(raw), [
                np.asarray(x) for x in vjp(jnp.asarray(g))[0]])
    return ((depth, skips, mr, mv), flat,
            [torch.from_numpy(x) for x in (pts, views, g)], want)


@pytest.mark.parametrize("use_viewdirs", [True, False],
                         ids=["viewdirs", "output_head"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_mlp_matches_jax(case, use_viewdirs):
    """#12: the plain version (the CPU path of `fused_mlp`) against the
    JAX v1 kernel, fp32 and bf16, with the view branch or the
    use_viewdirs=False output head; the v1 packing walked as the kernel
    walks it gives the same."""
    depth, skips, mr, mv = CASES[case]
    params, flat = _params(depth, skips, mr, mv, use_viewdirs)
    pts, views, _ = _streams(n=200, seed=6)
    kw = dict(net_depth=depth, skips=skips, multires=mr, multires_views=mv,
              use_viewdirs=use_viewdirs)
    before = fm.launches
    for dt, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        want = np.asarray(jfm.fused_mlp(
            params, jnp.asarray(pts), jnp.asarray(views), tile=64,
            interpret=True, compute_dtype=jdt, **kw))
        got = fm.fused_mlp(flat, torch.from_numpy(pts),
                           torch.from_numpy(views), compute_dtype=dt, **kw)
        assert got.shape == (200, 4 if use_viewdirs else OUTPUT_CH)
        packed = fm.pack_v1(flat, depth, skips, mr, mv, dt,
                            use_viewdirs=use_viewdirs)
        walk = v2.packed_reference_T(packed, torch.from_numpy(pts).T,
                                     torch.from_numpy(views).T).T
        if dt == "float32":
            np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
            np.testing.assert_allclose(walk.numpy(), want, **FP32_TOL)
        else:
            assert _bf16_close(got.numpy(), want)
            assert _bf16_close(walk.numpy(), want)
        # The packed weights take the same CPU path.
        assert torch.equal(fm.fused_mlp(packed, torch.from_numpy(pts),
                                        torch.from_numpy(views),
                                        compute_dtype=dt, **kw), got)
    assert fm.launches == before  # CPU tensors: no kernel


def test_fused_mlp_refuses_what_v1_cannot():
    """`fused_mlp` takes the flat list or a PackedMLP and refuses a state
    dict; the packing refuses a width off the wmma tiles and an encoding
    past the shared-memory plan, naming the reason, and a v2 packing
    refuses a skip into the heads."""
    depth, skips, mr, mv = CASES["skip_heads"]
    _, flat = _params(depth, skips, mr, mv, True)
    pts, views, _ = (torch.from_numpy(x) for x in _streams(n=50))
    sd = {f"w{i}": w for i, w in enumerate(flat)}
    kw = dict(net_depth=depth, skips=skips, multires=mr, multires_views=mv)
    with pytest.raises(TypeError, match="flat weight list"):
        fm.fused_mlp(sd, pts, views, **kw)
    with pytest.raises(ValueError, match="v1 kernels take a skip"):
        v2.pack(flat, depth, skips, mr, mv, "float32")
    wide = fm.flatten_params(
        interop.mlp_state_from_jax(jax.tree_util.tree_map(
            np.asarray, JaxNeRFMLP(net_depth=2, net_width=48).init(
                jax.random.PRNGKey(1), jnp.zeros((2, 63)),
                jnp.zeros((2, 27)))["params"])), True, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        fm.pack_v1(wide, 2, (), 10, 4, "bfloat16")
    big = fm.flatten_params(
        interop.mlp_state_from_jax(jax.tree_util.tree_map(
            np.asarray, JaxNeRFMLP(net_depth=2, net_width=256).init(
                jax.random.PRNGKey(1), jnp.zeros((2, 3 * (1 + 2 * 48))),
                jnp.zeros((2, 27)))["params"])), True, 2)
    with pytest.raises(ValueError, match="shared-memory plan"):
        fm.pack_v1(big, 2, (), 48, 4, "bfloat16")


def test_v1_train_forward_matches_jax(v1_case):
    """#13: the plain version against the JAX `_fwd_pallas`."""
    (depth, skips, mr, mv), flat, (pts, views, _), want = v1_case
    before = fmt.fwd_launches
    got = fmt.forward(flat, pts, views, depth, skips, mr, mv, "float32")
    np.testing.assert_allclose(got.numpy(), want["fp32"]["fwd"], **FP32_TOL)
    got16 = fmt.forward(flat, pts, views, depth, skips, mr, mv, "bfloat16")
    assert _bf16_close(got16.numpy(), want["bf16"]["fwd"])
    assert fmt.fwd_launches == before


def test_v1_weight_grads_match_jax(v1_case):
    """#14: the plain version in fp32 at DW_TOL, and the v1 packing's
    backward walk (the kernel's rounding) in bf16, against the JAX
    kernel's grads."""
    (depth, skips, mr, mv), flat, (pts, views, g), want = v1_case
    before = fmt.bwd_launches
    got = fmt.backward(flat, pts, views, g, depth, skips, mr, mv, "float32")
    assert [x.shape for x in got] == [w.shape for w in flat]
    for i, (a, b) in enumerate(zip(_jax_layout(got),
                                   want["fp32"]["train"][1])):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   err_msg=f"weight {i}", **DW_TOL)
    packed = fm.pack_v1(flat, depth, skips, mr, mv, "bfloat16")
    walk = v2.packed_bwd_reference_T(packed, pts.T, views.T, g.T)
    for i, (a, b) in enumerate(zip(_jax_layout(walk),
                                   want["bf16"]["train"][1])):
        assert _bf16_close(a, b), f"weight {i}"
    assert fmt.bwd_launches == before


@pytest.mark.parametrize("hybrid", [False, True], ids=["train", "hybrid"])
def test_v1_ops_autograd_match_jax(v1_case, hybrid):
    """fused_mlp_train (#13, #14) and hybrid_mlp_train (the plain forward,
    #14): the raw output and, by autograd, the weight grads of the JAX
    ops; the points and view directions get zero grads, as in the JAX
    VJP."""
    (depth, skips, mr, mv), flat, (pts, views, g), want = v1_case
    want_raw, want_grads = want["fp32"]["hybrid" if hybrid else "train"]
    leaves = [w.clone().requires_grad_() for w in flat]
    p, v = pts.clone().requires_grad_(), views.clone().requires_grad_()
    op = fmt.hybrid_mlp_train if hybrid else fmt.fused_mlp_train
    raw = op(leaves, p, v, depth, skips, mr, mv, "float32")
    np.testing.assert_allclose(raw.detach().numpy(), want_raw, **FP32_TOL)
    (raw * g).sum().backward()
    for i, (a, b) in enumerate(zip(_jax_layout([w.grad for w in leaves]),
                                   want_grads)):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   err_msg=f"weight {i}", **DW_TOL)
    assert torch.equal(p.grad, torch.zeros_like(p))
    assert torch.equal(v.grad, torch.zeros_like(v))
