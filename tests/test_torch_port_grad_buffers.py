"""The weight-grad wrappers' buffers and C calls, on the CPU.

Every weight-grad kernel, the transposed #2 and #7 (`csrc/fused_mlp_bwd.cu`,
`csrc/fused_mip_bwd.cu`), their row-major twins #11 (`fused_mlp_bwd_row`)
and #16 (`fused_mip_bwd_row`) and the v1 kernel #14
(`csrc/fused_mlp_v1_bwd.cu`), runs `level_train.cuh`'s walk and dW GEMM:
their plans fill nine slots and their entry points take a split-partial
buffer (`gpart`) after the block partials. A plan written into a shorter
array corrupts memory without an error, and a wrong argument count passes
garbage pointers without one, so the wrappers' side of each call is held
here with fake entry points in place of the kernel library: the plan
array's length, the buffers' sizes against the plan's slots, and the
pointer and int counts against the `extern "C"` declarations in the
committed sources. The last tests read the forward sources: #15
(`fused_mip_fwd_row`) runs #6's plan and the Hopper walk under the
row-major layout.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mip as fmip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from torch_port_shared import _one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "consistentnerf_tpu_torch" / \
    "csrc"
N = 300
# Slots a fake plan writes: blocks, workspace elements (in total),
# partial floats per block, shared memory, points per chunk, splits, split
# partial floats, slabs per split, the level walk.
PLAN9 = (7, 123_456, 320, 100_000, 768, 3, 3 * 777, 5, 1)
# The same slots as the fp32 plan fills them (train_block through
# legacy_level_plan: the last four 0).
PLAN9_LEGACY = (5, 4_321 * 5, 192, 90_000, 768, 0, 0, 0, 0)


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

    def __call__(self, lib, symbol, n_ptr, n_int):
        self.entries.append((symbol, n_ptr, n_int))

        def fn(*args):
            assert len(args) == n_ptr + n_int + 1
            if symbol.endswith("_plan"):
                out = args[-1]
                self.calls.append((symbol, len(out)))
                for i, v in enumerate(self.slots[:len(out)]):
                    out[i] = v
            else:
                self.calls.append((symbol, args[:n_ptr], args[n_ptr:-1]))
            return 0
        return fn


@pytest.fixture
def fake(monkeypatch):
    made = {}

    def install(slots):
        lib = FakeLibrary(slots)
        monkeypatch.setattr(v2, "_entry", lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: SimpleNamespace(cuda_stream=0))
        made["lib"] = lib
        bufs = []
        real = v2.level_buffers

        def record(*a):
            out = real(*a)
            bufs.append(out)
            return out
        monkeypatch.setattr(v2, "level_buffers", record)
        made["bufs"] = bufs
        return lib, bufs
    return install


def _nerf_packed(dtype, v1=False):
    mlp = NeRFMLP(net_depth=4, net_width=32, skips=(2,), input_ch=3 * 9,
                  input_ch_views=3 * 5)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    flat = fm.flatten_params(mlp, True, 4)
    if v1:
        return fm.pack_v1(flat, 4, (2,), 4, 2, dtype)
    return v2.pack(flat, 4, (2,), 4, 2, dtype)


def _mip_packed(dtype):
    mlp = MipMLP(net_depth=4, net_width=32, net_width_viewdirs=16,
                 max_deg_point=4)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    return fmip.pack(fmip.flatten_mip_params(mlp, 4), 4, 4, dtype)


def _streams(k, row, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = lambda c: (N, c) if row else (c, N)  # noqa: E731
    return [torch.rand(shape(3), generator=g) for _ in range(k)], \
        torch.randn(shape(4), generator=g)


def _check_call(lib, bufs, symbol, source, streams, g, packed, slots):
    """The plan got an array of len(slots); the buffers have the plan's
    sizes (a bf16 workspace where slot 8 says the level walk runs, its
    three planes in fp32; else of the compute type); the launch passed the
    streams, g, the weights (and, for #2, #11, #7 and #16, the fp32 planes
    w3, a null pointer in bf16) and the buffers in the C declaration's
    order and counts."""
    plan_calls = [c for c in lib.calls if c[0] == symbol + "_plan"]
    assert [c[1] for c in plan_calls] == [len(slots)] == [9]
    out, = bufs
    n_w, n_b = v2.grad_numel(packed)
    ws, part, gpart, dw = out
    assert ws.numel() == slots[1]
    assert part.numel() == slots[0] * slots[2]
    assert gpart.numel() == max(slots[6], 1)
    assert ws.dtype == (torch.bfloat16 if slots[8] else packed.compute_dtype)
    assert dw.numel() == n_w + n_b and dw.dtype == torch.float32
    (_, ptrs, ints), = [c for c in lib.calls if c[0] == symbol]
    w3 = []
    if symbol in v2.PLANE_ENTRIES:
        w3 = [None if packed.w3 is None else packed.w3.data_ptr()]
    want = [t.data_ptr() for t in (*streams, g, packed.w)] + w3 + [
        t.data_ptr() for t in (packed.b, *out)]
    assert list(ptrs) == want
    assert ints[0] == N
    entry = {s: (p, i) for s, p, i in lib.entries}
    assert entry[symbol] == c_signature(source, symbol)
    assert entry[symbol + "_plan"] == c_signature(source, symbol + "_plan")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_transposed_mlp_backward_sizes_from_nine_slots(fake, dtype):
    """#2: the nine-slot plan and its four buffers (ws, part, gpart, dw)
    in both types (in fp32 too the level walk runs, on the three bf16
    planes `w3` that the launch passes after the weights)."""
    lib, bufs = fake(PLAN9)
    packed = _nerf_packed(dtype)
    (pts, views), g = _streams(2, row=False)
    grads, launched = v2.dw_launch(v2.BWD_KERNEL, v2.BWD_KERNEL, packed,
                                   pts, views, g, row=False)
    assert launched and len(grads) == len(packed.flat)
    _check_call(lib, bufs, v2.BWD_KERNEL, "fused_mlp_bwd.cu", (pts, views),
                g, packed, PLAN9)


@pytest.mark.parametrize("kernel", ["v2row", "v1"])
def test_row_major_backward_sizes_from_nine_slots(fake, kernel):
    """#11 (`fused_mlp_bwd_row`) and #14 (`fused_mlp_v1_bwd`) on the
    nine-slot plan: four buffers (ws, part, gpart, dw), and the pointer
    and int counts of their C declarations, 9 pointers (pts, views, g,
    w, b and the buffers) and 7 ints; #11 also takes the fp32 planes w3
    after w (10 pointers)."""
    lib, bufs = fake(PLAN9)
    packed = _nerf_packed("bfloat16", v1=kernel == "v1")
    (pts, views), g = _streams(2, row=True)
    lib_name, symbol, source = (
        (v2.BWD_KERNEL, v2.ROW_BWD_KERNEL, "fused_mlp_bwd.cu")
        if kernel == "v2row" else
        (fmt.BWD_KERNEL, fmt.BWD_KERNEL, "fused_mlp_v1_bwd.cu"))
    grads, launched = v2.dw_launch(lib_name, symbol, packed, pts, views, g,
                                   row=True)
    assert launched and len(grads) == len(packed.flat)
    _check_call(lib, bufs, symbol, source, (pts, views), g, packed, PLAN9)
    assert c_signature(source, symbol) == (9 + (kernel == "v2row"), 7)
    assert c_signature(source, symbol + "_plan") == (0, 7)


def test_every_weight_grad_entry_takes_the_buffers_of_its_plan():
    """Every weight-grad entry point in the committed sources takes gpart
    after part, and `grad_launch` sizes each by the nine-slot plan: the
    wrapper keeps no other buffer sizer."""
    entries = {"fused_mlp_bwd.cu": ("fused_mlp_bwd", "fused_mlp_bwd_row"),
               "fused_mip_bwd.cu": ("fused_mip_bwd", "fused_mip_bwd_row"),
               "fused_mlp_v1_bwd.cu": ("fused_mlp_v1_bwd",)}
    assert not hasattr(v2, "FOUR_SLOT_PLANS")
    assert not hasattr(v2, "train_buffers")
    for source, symbols in entries.items():
        text = (CSRC / source).read_text()
        for symbol in symbols:
            m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text,
                          re.S)
            assert "void* part, void* gpart" in " ".join(m.group(1).split()), \
                symbol


# Slot 3 of #14's bf16 plan as chip_smoke.py printed it on an H100 (132
# SMs) at 8x256, multires / multires_views, for the chunk rows it picked:
# (multires, rows) -> bytes.
CARD_WALK_SMEM = {(10, 576): 212_480, (10, 192): 204_800,
                  (21, 576): 222_720}


@pytest.mark.parametrize("multires", [10, 21])
def test_the_level_walk_holds_the_v1_shapes(multires):
    """The bf16 walk of #11 and #14 (with the row-major staging) fits a
    block's shared memory at 8x256 with 768-point chunks at multires 10
    (the main path) and 21, and at a depth-5 skip into the heads, so the
    plans pick it there; from multires 29 only train_block still fits.
    The wrapper's figure is the kernel's plan as the card reported it."""
    for depth in (8, 5):
        mlp = NeRFMLP(net_depth=depth, input_ch=3 * (1 + 2 * multires),
                      skips=(4,))
        packed = fm.pack_v1(fm.flatten_params(mlp, True, depth), depth,
                            (4,), multires, 4, "bfloat16")
        assert fm.walk_smem_bytes(packed, 768) <= fm.SMEM_LIMIT
        for (mr, rows), card in CARD_WALK_SMEM.items():
            if mr == multires:
                assert fm.walk_smem_bytes(packed, rows) == card
    mlp = NeRFMLP(input_ch=3 * (1 + 2 * 29))
    packed = fm.pack_v1(fm.flatten_params(mlp), 8, (4,), 29, 4, "bfloat16")
    assert fm.walk_smem_bytes(packed, 768) > fm.SMEM_LIMIT
    assert fm.v1_smem_bytes(packed)[1] <= fm.SMEM_LIMIT


@pytest.mark.parametrize("row", [False, True])
def test_mip_backward_sizes_from_its_plan(fake, row):
    """#7 and #16 on the nine-slot plan, through the call that
    `fused_mip._bwd` makes: four buffers (ws, part, gpart, dw)."""
    lib, bufs = fake(PLAN9)
    packed = _mip_packed("bfloat16")
    streams, g = _streams(3, row)
    symbol = fmip.ROW_BWD_KERNEL if row else fmip.BWD_KERNEL
    grads, launched = v2.grad_launch(fmip.BWD_KERNEL, symbol, packed,
                                     streams, g, fmip._cfg_args(packed), row)
    assert launched and len(grads) == len(packed.flat)
    _check_call(lib, bufs, symbol, "fused_mip_bwd.cu", streams, g, packed,
                PLAN9)


def test_fp32_mip_row_backward_sizes_from_the_legacy_slots(fake):
    """fp32 #16 on a plan of train_block (`legacy_level_plan`, which its
    widths over 256 take): nine slots with the last four 0, a workspace
    of blocks x per-block elements in slot 1 and of the compute type, a
    one-float gpart that the legacy launch does not read, and the fp32
    planes w3 passed after w all the same."""
    lib, bufs = fake(PLAN9_LEGACY)
    packed = _mip_packed("float32")
    streams, g = _streams(3, row=True)
    grads, launched = v2.grad_launch(
        fmip.BWD_KERNEL, fmip.ROW_BWD_KERNEL, packed, streams, g,
        fmip._cfg_args(packed), True)
    assert launched and len(grads) == len(packed.flat)
    _check_call(lib, bufs, fmip.ROW_BWD_KERNEL, "fused_mip_bwd.cu", streams,
                g, packed, PLAN9_LEGACY)
    ws, _, gpart, _ = bufs[0]
    assert ws.dtype == torch.float32 and gpart.numel() == 1


def test_mip_row_backward_declares_nine_slot_signatures():
    """`fused_mip_bwd_row` takes 11 pointers (means, covs, views, g, w, the
    fp32 planes w3, b, ws, part, gpart, dw) and 8 ints, as `fused_mip_bwd`
    does, and its plan fills `plan9<T, RowMajor>`, as
    `fused_mlp_bwd_row_plan` does."""
    src = "fused_mip_bwd.cu"
    assert c_signature(src, fmip.ROW_BWD_KERNEL) == (11, 8)
    assert c_signature(src, fmip.BWD_KERNEL) == (11, 8)
    assert {fmip.BWD_KERNEL, fmip.ROW_BWD_KERNEL} <= set(v2.PLANE_ENTRIES)
    assert c_signature(src, fmip.ROW_BWD_KERNEL + "_plan") == (0, 8)
    text = (CSRC / src).read_text()
    body = text[text.index('int fused_mip_bwd_row_plan('):]
    body = body[:body.index("}")]
    assert "plan9<bf16, mlp::RowMajor>" in body
    assert "plan9<float, mlp::RowMajor>" in body
    assert "mlp::plan<" not in body
    # The walk branch under the stream layout, for both layouts and both
    # types.
    assert "mlp::level_walk<2, mlp::MipEnc, L, false, T>" in text
    assert "mlp::level_plan<L, false, T>" in text
    assert "!L::kRow" not in text


def test_mip_row_forward_runs_the_walk_of_6():
    """#15 (`fused_mip_fwd_row`) runs the plan and the walk of #6: one
    helper for both entries, the Hopper walk instantiated under the
    layout, and a plan that no longer refuses the row-major layout."""
    text = (CSRC / "fused_mip_fwd.cu").read_text()
    plan = text[text.index('int fused_mip_fwd_plan('):]
    plan = plan[:plan.index("\n}")]
    assert "!row" not in plan and "mip_instance(d)" in plan
    assert c_signature("fused_mip_fwd.cu", "fused_mip_fwd_plan") == (0, 9)
    assert "fh_launch<MipEnc, 4, 2, H, 0, L>" in text
    for symbol, layout in (("fused_mip_fwd", "ColMajor"),
                           ("fused_mip_fwd_row", "RowMajor")):
        assert c_signature("fused_mip_fwd.cu", symbol) == (6, 8)
        body = text[text.index(f'extern "C" int {symbol}('):]
        body = body[:body.index("\n}")]
        assert f"mip_forward<mlp::{layout}>" in body, symbol


@pytest.mark.parametrize("num_freqs", [16, 12])
def test_the_level_walk_holds_the_mip_row_shapes(num_freqs):
    """#16's bf16 walk with the row-major staging fits a block's shared
    memory at 8x256 with 768-point chunks at 16 IPE frequencies (96
    columns, the main path) and 12 (72 columns, padded to 80), so its
    plan picks the level walk there. At the chunk rows #14 took on the
    card (576) it lies between #14's footprints at multires 10 (P = 64)
    and 21 (P = 144), both of which ran."""
    mlp = MipMLP(max_deg_point=num_freqs)
    packed = fmip.pack(fmip.flatten_mip_params(mlp, 8), 8, num_freqs,
                       "bfloat16")
    assert packed.encoder == "ipe"
    assert fm.walk_smem_bytes(packed, 768) <= fm.SMEM_LIMIT
    assert CARD_WALK_SMEM[(10, 576)] < fm.walk_smem_bytes(packed, 576) \
        < CARD_WALK_SMEM[(21, 576)]


def test_no_points_launch_nothing(fake):
    """N = 0: zero grads, no plan and no launch."""
    lib, _ = fake(PLAN9)
    packed = _nerf_packed("bfloat16")
    pts, views = torch.zeros(3, 0), torch.zeros(3, 0)
    grads, launched = v2.dw_launch(v2.BWD_KERNEL, v2.BWD_KERNEL, packed,
                                   pts, views, torch.zeros(4, 0), row=False)
    assert not launched and lib.calls == []
    assert all(not x.any() for x in grads)


def test_a_failed_plan_raises(fake, monkeypatch):
    fake(PLAN9)
    def failing(lib, symbol, n_ptr, n_int):
        return lambda *a: 2  # cudaErrorMemoryAllocation
    monkeypatch.setattr(v2, "_entry", failing)
    packed = _nerf_packed("bfloat16")
    (pts, views), g = _streams(2, row=False)
    with pytest.raises(RuntimeError, match="plan failed: cudaError_t 2"):
        v2.dw_launch(v2.BWD_KERNEL, v2.BWD_KERNEL, packed, pts, views, g,
                     row=False)
