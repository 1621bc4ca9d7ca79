"""The wrappers' side of kernels 6n and #4 on the Hopper walk's tails, on
the CPU, with fake entry points in place of the kernel library (as
`tests/test_torch_port_grad_buffers.py` holds the weight grads'):

* 6n (`fused_mip.normals_launch`): the plan array's ten slots, no
  workspace where the plan runs the Hopper walk and mode 5's where it does
  not, and the pointer and int counts of `fused_mip_fwd_normals` and its
  plan against their `extern "C"` declarations in `csrc/fused_mip_fwd.cu`;
* #4 (`fused_onepass.render_launch`): the plan's eight slots and the
  counts of `render_level` and `render_level_plan` against
  `csrc/render_level.cu`;
* #4's group arithmetic mirrored in Python (`render_group`,
  `render_smem_bytes`): points, tiles and rays a group at S = 48, 64, 96
  and 192, whose groups fit beside the walk at 8x256, and an S whose
  group does not;
* the row-major forwards on the walk, #10 (`fused_mlp_fwd_row`) and the
  v1 forward #12 / #13 (`fused_mlp_v1_fwd`): their plans' eight slots
  (`fused_mlp_v2.fwd_plan(row=True)`, `fused_mlp.fwd_plan`) and the
  pointer and int counts of the plans and the launches against
  `csrc/fused_mlp_fwd.cu` and `csrc/fused_mlp_v1_fwd.cu`.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from torch_port_shared import _one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "consistentnerf_tpu_torch" / \
    "csrc"
N = 300
# A fake 6n plan: the Hopper walk (slot 0 = 1, masks in registers, no
# workspace) or mode 5 (slot 0 = 0, slot 9 the workspace's elements).
NORMALS_HOPPER = (1, 128, 2, 1, 220_000, 3, 2, 3, 1, 0)
NORMALS_MODE5 = (0, 768, 0, 1, 90_000, 1, 0, 1, 0, 4_321)
RENDER_PLAN = (1, 384, 3, 2, 231_520, 132, 3, 4096)
# A fake forward plan: the Hopper walk at 8192 x 192 points.
FWD_PLAN = (1, 128, 3, 1, 225_360, 132, 2, 12_288)


def c_signature(source: str, symbol: str):
    """(pointer parameters, int parameters) of `extern "C" int symbol(...)`
    in csrc/source, the last pointer (the stream or the plan's output)
    not counted."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, f"{symbol} is not declared in {source}"
    params = [p.strip() for p in m.group(1).split(",")]
    ptrs = sum("*" in p for p in params) - 1
    ints = sum(p.startswith("int ") for p in params)
    assert ptrs + ints + 1 == len(params)
    return ptrs, ints


class FakeLibrary:
    """`v2._entry` with fake entry points: a plan writes `slots` into its
    output array (and records the array's length); a launch records its
    pointers and ints and returns cudaSuccess."""

    def __init__(self, slots):
        self.slots, self.calls, self.entries = slots, [], []
        self.plan_ints = {}

    def __call__(self, lib, symbol, n_ptr, n_int):
        self.entries.append((lib, symbol, n_ptr, n_int))

        def fn(*args):
            assert len(args) == n_ptr + n_int + 1
            if symbol.endswith("_plan"):
                out = args[-1]
                self.calls.append((symbol, len(out)))
                self.plan_ints[symbol] = args[n_ptr:-1]
                for i, v in enumerate(self.slots[:len(out)]):
                    out[i] = v
            else:
                self.calls.append((symbol, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return fn


@pytest.fixture
def fake(monkeypatch):
    def install(slots):
        lib = FakeLibrary(slots)
        monkeypatch.setattr(v2, "_entry", lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: SimpleNamespace(cuda_stream=0))
        return lib
    return install


def _mip(dtype):
    mlp = MipMLP(net_depth=4, net_width=32, net_width_viewdirs=16,
                 max_deg_point=4)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    packed = fmip.pack(fmip.flatten_mip_params(mlp, 4), 4, 4, dtype)
    g = torch.Generator().manual_seed(1)
    return packed, [torch.rand(3, N, generator=g) for _ in range(3)]


def _nerf(dtype, seg):
    mlp = NeRFMLP(net_depth=4, net_width=32, skips=(2,), input_ch=3 * 9,
                  input_ch_views=3 * 5)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    packed = v2.pack(fm.flatten_params(mlp, True, 4), 4, (2,), 4, 2, dtype)
    g = torch.Generator().manual_seed(1)
    n = N // seg * seg
    return packed, (torch.rand(3, n, generator=g),
                    torch.rand(3, n, generator=g),
                    torch.rand(1, n, generator=g),
                    torch.rand(1, n, generator=g))


@pytest.mark.parametrize("slots", [NORMALS_HOPPER, NORMALS_MODE5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normals_workspace_follows_its_plan(fake, monkeypatch, slots,
                                            dtype):
    """The plan's ten slots; no workspace on the Hopper walk (a null
    pointer), mode 5's elements of the compute type otherwise; the launch
    passes the streams, weights, workspace and out in the C order."""
    lib = fake(slots)
    packed, streams = _mip(dtype)
    made = []
    real_empty = torch.empty

    def spy(*a, **k):
        t = real_empty(*a, **k)
        made.append(t)
        return t
    monkeypatch.setattr(torch, "empty", spy)
    out = fmip.normals_launch(packed, *streams)
    assert out.shape == (7, N) and out.dtype == torch.float32
    assert [c[1] for c in lib.calls
            if c[0] == fmip.NORMALS_KERNEL + "_plan"] == [10]
    assert len(fmip.NORMALS_PLAN_SLOTS) == 10
    (_, ptrs, ints), = [c for c in lib.calls if c[0] == fmip.NORMALS_KERNEL]
    ws = [t for t in made if t is not out]
    if slots[0]:
        assert ws == [] and ptrs[5] is None
    else:
        (w,), = [ws]
        assert w.numel() == slots[9] and w.dtype == packed.compute_dtype
        assert ptrs[5] == w.data_ptr()
    want = [s.data_ptr() for s in streams] + [packed.w.data_ptr(),
                                              packed.b.data_ptr()]
    assert list(ptrs[:5]) == want and ptrs[6] == out.data_ptr()
    assert list(ints) == [N, *fmip._cfg_args(packed)]
    entry = {s: (p, i) for _, s, p, i in lib.entries}
    for symbol in (fmip.NORMALS_KERNEL, fmip.NORMALS_KERNEL + "_plan"):
        assert entry[symbol] == c_signature("fused_mip_fwd.cu", symbol)
    assert c_signature("fused_mip_fwd.cu", fmip.NORMALS_KERNEL) == (7, 8)


def test_normals_plan_dict(fake):
    fake(NORMALS_HOPPER)
    packed, _ = _mip("bfloat16")
    plan = fmip.normals_plan(packed, N)
    assert plan == dict(zip(fmip.NORMALS_PLAN_SLOTS, NORMALS_HOPPER))
    assert plan["hopper"] == 1 and plan["masks_in_registers"] == 1


@pytest.mark.parametrize("seg", [64, 48])
def test_render_launch_calls_the_c_declarations(fake, seg):
    """#4's launch: 7 pointers (pts, views, z, |d| per ray, w, b, out) and
    9 ints; its plan 8 ints and eight slots; |d| is taken once a ray."""
    lib = fake(RENDER_PLAN)
    packed, (pts, views, z, dn) = _nerf("bfloat16", seg)
    out = op.render_launch(packed, pts, views, z, dn, seg, True)
    n = pts.shape[1]
    assert out.shape == (6, n)
    (_, ptrs, ints), = [c for c in lib.calls if c[0] == op.RENDER_KERNEL]
    assert list(ptrs[:2]) == [pts.data_ptr(), views.data_ptr()]
    assert ptrs[2] == z.data_ptr() and ptrs[6] == out.data_ptr()
    assert list(ints) == [n // seg, seg, 4, 32, 1 << 2, 4, 2, 1, 1]
    plan = op.render_plan(packed, n // seg, seg)
    assert plan == dict(zip(op.RENDER_PLAN_SLOTS, RENDER_PLAN))
    assert [c[1] for c in lib.calls
            if c[0] == op.RENDER_KERNEL + "_plan"] == [8]
    entry = {s: (p, i) for _, s, p, i in lib.entries}
    for symbol in (op.RENDER_KERNEL, op.RENDER_KERNEL + "_plan"):
        assert entry[symbol] == c_signature("render_level.cu", symbol)
    assert c_signature("render_level.cu", op.RENDER_KERNEL) == (7, 9)
    assert c_signature("render_level.cu", op.RENDER_KERNEL + "_plan") == \
        (0, 8)


# lcm(S, 128) points: (points, tiles, rays) a group.
GROUPS = {48: (384, 3, 8), 64: (128, 1, 2), 96: (384, 3, 4),
          192: (384, 3, 2)}


@pytest.mark.parametrize("seg", sorted(GROUPS))
def test_render_groups_hold_whole_rays(seg):
    """A group is whole rays in whole tiles, and at 8x256 (multires 10 /
    4) its heads buffer fits beside the walk with two pe buffers and a
    3-slot ring; the fine level's 384 points take 231,520 bytes of the
    232,448 a block may have."""
    gp, gt, rays = op.render_group(seg)
    assert (gp, gt, rays) == GROUPS[seg]
    assert gp % seg == 0 and gp % op.FH_TILE == 0 and gp == gt * 128
    packed = v2.pack(fm.flatten_params(NeRFMLP()), 8, (4,), 10, 4,
                     "bfloat16")
    smem, stages, npe = op.render_smem_bytes(packed, seg)
    assert (stages, npe) == (3, 2) and smem <= fm.SMEM_LIMIT
    if gp == 384:
        assert smem == 231_520


def test_a_group_that_does_not_fit_keeps_the_old_kernel():
    """S = 150: lcm(150, 128) = 9600 points, 153,600 bytes of heads, more
    than any ring and pe buffers leave at 8x256: no plan fits (the old
    kernel runs). S = 100's 3200 points still fit, with one pe buffer and
    a 2-slot ring."""
    packed = v2.pack(fm.flatten_params(NeRFMLP()), 8, (4,), 10, 4,
                     "bfloat16")
    assert op.render_group(150) == (9600, 75, 64)
    assert op.render_smem_bytes(packed, 150) is None
    assert op.render_smem_bytes(packed, 100)[1:] == (2, 1)


def _row_fwd(which, dtype="bfloat16"):
    """(packed weights, [N, 3] points, [N, 3] views, C entry, source) of
    #10 ("row": `fused_mlp_v2.pack`) or #12 / #13 ("v1": `pack_v1`)."""
    mlp = NeRFMLP(net_depth=4, net_width=64, skips=(2,), input_ch=3 * 9,
                  input_ch_views=3 * 5)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    flat = fm.flatten_params(mlp, True, 4)
    g = torch.Generator().manual_seed(1)
    pts, views = (torch.rand(N, 3, generator=g) for _ in range(2))
    if which == "row":
        return (v2.pack(flat, 4, (2,), 4, 2, dtype), pts, views,
                v2.ROW_KERNEL, "fused_mlp_fwd.cu")
    return (fm.pack_v1(flat, 4, (2,), 4, 2, dtype), pts, views, fm.KERNEL,
            "fused_mlp_v1_fwd.cu")


@pytest.mark.parametrize("which", ["row", "v1"])
def test_row_forward_plans_fill_eight_slots(fake, which):
    """#10's plan is `fused_mlp_fwd_plan` with row = 1; #12 / #13's the new
    `fused_mlp_v1_fwd_plan`, which also takes the output head's channels:
    8 ints each and the eight slots of `PLAN_SLOTS`."""
    lib = fake(FWD_PLAN)
    packed, *_ = _row_fwd(which)
    if which == "row":
        plan, symbol = v2.fwd_plan(packed, N, row=True), "fused_mlp_fwd_plan"
        source, last = "fused_mlp_fwd.cu", 1
    else:
        plan, symbol = fm.fwd_plan(packed, N), fm.KERNEL + "_plan"
        source, last = "fused_mlp_v1_fwd.cu", packed.out_ch
    assert plan == dict(zip(v2.PLAN_SLOTS, FWD_PLAN))
    assert len(v2.PLAN_SLOTS) == 8
    assert [c[1] for c in lib.calls if c[0] == symbol] == [8]
    assert list(lib.plan_ints[symbol]) == [N, *v2._cfg_ints(packed), last]
    entry = {s: (p, i) for _, s, p, i in lib.entries}
    assert entry[symbol] == c_signature(source, symbol) == (0, 8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("which", ["row", "v1"])
def test_row_forward_launches_call_the_c_declarations(fake, which, dtype):
    """#10 and #12 / #13 launch with 5 pointers (pts, views, w, b, out)
    and the config's ints (#12 / #13 also out_ch) on [N, 3] streams into
    a fresh [N, 4]; the C entries take exactly those counts."""
    lib = fake(FWD_PLAN)
    packed, pts, views, symbol, source = _row_fwd(which, dtype)
    if which == "row":
        out, launched = v2.fwd_launch(v2.KERNEL, symbol, packed, pts, views,
                                      True)
    else:
        out, launched = fm.v1_forward(packed, pts, views)
    assert launched and out.shape == (N, 4) and out.dtype == torch.float32
    (_, ptrs, ints), = [c for c in lib.calls if c[0] == symbol]
    assert list(ptrs) == [pts.data_ptr(), views.data_ptr(),
                          packed.w.data_ptr(), packed.b.data_ptr(),
                          out.data_ptr()]
    extra = [packed.out_ch] if which == "v1" else []
    assert list(ints) == [N, *v2._cfg_ints(packed), *extra]
    entry = {s: (p, i) for _, s, p, i in lib.entries}
    assert entry[symbol] == c_signature(source, symbol)
    assert c_signature(source, symbol) == (5, 7 + len(extra))
