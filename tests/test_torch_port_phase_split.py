"""tools/torch_phase_split.py's patching of the level kernels' header and
of the forward walk's.

The tool times #3 and #5 (and #2, #7, #11 and #14, the same walk in mode
2) with
their phases cut out by preprocessor guards that it writes into a copy
of `csrc/level_train.cuh` at string anchors, and #1, #10 and #6 likewise
with a copy of `csrc/fwd_hopper.cuh` (the heads, the encoding, the
epilogue). The timing needs a card; the patching is string work,
checked here against the committed sources, so that an edit of a header
cannot leave a phase in the timed variants silently.
"""

import sys
from pathlib import Path

import pytest
from torch_port_shared import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_phase_split as tps  # noqa: E402

CSRC = REPO / "consistentnerf_tpu_torch" / "csrc"


def test_every_anchor_is_found_in_the_committed_header():
    out = tps.patched_sources(CSRC)
    header = out[tps.HEADER]
    # The backward (its loop and its products in the weight stream), the
    # dW GEMM, and every save.
    assert header.count("#ifndef PHASE_NO_BWD") == 1
    assert header.count("#ifdef PHASE_NO_BWD") == 1
    assert header.count("#ifndef PHASE_NO_DW") == 1
    assert header.count("PHASE_SAVE(") == tps.SAVE_CALLS + 2
    assert "save_rows<M>(" not in header.replace(
        "#define PHASE_SAVE(...) save_rows<M>(__VA_ARGS__)", "")
    assert header.count("PHASE_SAVE3(") == tps.SAVE_CALLS + 2
    assert "save_rows3<M>(" not in header.replace(
        "#define PHASE_SAVE3(...) save_rows3<M>(__VA_ARGS__)", "")


@pytest.mark.parametrize("source", tps.SOURCES)
def test_both_level_kernels_build_from_the_patched_header(source):
    out = tps.patched_sources(CSRC)
    assert f'#include "{tps.HEADER}"' in out[source]
    # Every other header is copied unchanged beside it.
    for header in CSRC.glob("*.cuh"):
        if header.name != tps.HEADER:
            assert out[header.name] == header.read_text()


def test_the_weight_grad_kernels_are_split_with_the_levels(tmp_path):
    """#2 and #7 run the level walk in mode 2: the phase-split build
    writes their sources beside the patched header, and mode 2's
    cotangent load sits between the forward and the guarded backward, so
    the "forward" variant keeps it and no anchor count changes."""
    for name, text in tps.patched_sources(CSRC).items():
        (tmp_path / name).write_text(text)
    header = (tmp_path / tps.HEADER).read_text()
    for source in ("fused_mlp_bwd.cu", "fused_mip_bwd.cu",
                   "fused_mlp_v1_bwd.cu"):
        assert source in tps.SOURCES
        assert f'#include "{tps.HEADER}"' in (tmp_path / source).read_text()
    load = header.index("craw[e] = p < valid ? gin[")
    forward = header.rindex("// ---- forward over sub-tiles", 0, load)
    assert forward < load < header.index("#ifndef PHASE_NO_BWD")


def test_the_row_major_weight_grads_are_split_with_the_levels(tmp_path):
    """#11 (`fused_mlp_bwd_row`) and #14 run the level walk on row-major
    streams: #14's source is built from the patched header beside #2's,
    the row-major cotangent read (a point's 4 floats) sits, like the
    transposed one, between the forward and the guarded backward, and
    the two-call fine level where the tool splits #2, #11 and #14 on the
    same points is 5120 rays x 192 samples."""
    for name, text in tps.patched_sources(CSRC).items():
        (tmp_path / name).write_text(text)
    header = (tmp_path / tps.HEADER).read_text()
    v1 = (tmp_path / "fused_mlp_v1_bwd.cu").read_text()
    assert f'#include "{tps.HEADER}"' in v1
    assert "level_walk<2, mlp::NerfEnc, mlp::RowMajor, HS>" in v1
    assert "level_walk<2, mlp::NerfEnc, L, false, T>" in (
        tmp_path / "fused_mlp_bwd.cu").read_text()
    load = header.index("craw[3 * rows + p] = v.w;")
    forward = header.rindex("// ---- forward over sub-tiles", 0, load)
    assert forward < load < header.index("#ifndef PHASE_NO_BWD")
    assert header.index("craw[e] = p < valid ? gin[") < header.index(
        "#ifndef PHASE_NO_BWD")
    assert tps.TWOCALL_FINE == 983_040


@pytest.mark.parametrize("part", ["level", "fwd"])
def test_the_row_major_mip_kernels_are_split_with_their_twins(part):
    """#16 (`fused_mip_bwd_row`) runs the level walk and #15
    (`fused_mip_fwd_row`) the forward walk under the row-major layout,
    each from the same patched source as its transposed twin (#7, #6), so
    their variants cut the same regions; the tool splits #7 and #16 on
    the same points of the mip level, 4096 rays x 96 samples."""
    if part == "level":
        text = tps.patched_sources(CSRC)["fused_mip_bwd.cu"]
        assert "fused_mip_bwd.cu" in tps.SOURCES
        assert "mlp::level_walk<2, mlp::MipEnc, L>" in text
        assert "return run<mlp::RowMajor>(" in text
        assert tps.MIP_LEVEL == 393_216
    else:
        text = tps.patched_fwd_sources(CSRC)["fused_mip_fwd.cu"]
        assert "fused_mip_fwd.cu" in tps.FWD_SOURCES
        assert "mip_forward<mlp::RowMajor>" in text
        assert "fh_launch<MipEnc, 4, 2, H, 0, L>" in text


@pytest.mark.parametrize("anchor", [
    "    // ---- backward over sub-tiles ----",
    "    // ---- end of the backward ----",
    "  // ---- the dW GEMM ----",
    "  // ---- end of the dW GEMM ----",
    "  return d.depth + 1;\n",
])
def test_a_missing_anchor_fails_the_patch(anchor):
    text = (CSRC / tps.HEADER).read_text()
    assert text.count(anchor) == 1
    with pytest.raises(ValueError, match="occurs 0 times"):
        tps.patched_header(text.replace(anchor, ""))


def test_a_save_more_or_less_fails_the_patch():
    text = (CSRC / tps.HEADER).read_text()
    extra = text.replace("save_rows<M>(pe,", "save_rows<M>(pe,", 1) + (
        "\n// save_rows<M>(\n")
    with pytest.raises(ValueError, match="save_rows"):
        tps.patched_header(extra)


def test_every_forward_anchor_is_found_in_the_committed_header():
    header = tps.patched_fwd_sources(CSRC)[tps.FWD_HEADER]
    # Both heads, the three encoders' feature computations, the epilogue.
    assert header.count("#ifndef PHASE_NO_HEADS") == 2
    assert header.count("#ifndef PHASE_NO_ENCODE") == 3
    assert header.count("#ifndef PHASE_NO_EPILOGUE") == 1
    # Each guard closes right after its region's last line.
    for first, last, macro, count in tps.FWD_REGIONS:
        assert header.count(f"#ifndef {macro}\n{first}\n") == count
        assert header.count(f"{last}\n#endif\n") == count


def test_the_row_major_forward_is_split_with_the_walk():
    """#10 (`fused_mlp_fwd_row`) runs the walk under the row-major layout
    from the same patched source as #1, so its variants cut the same
    regions: every guarded encoder reads its points through the layout,
    and both heads store with the layout's strides."""
    out = tps.patched_fwd_sources(CSRC)
    assert "fh_nerf_forward<mlp::RowMajor>" in out[
        "fused_mlp_fwd.cu"]
    header = out[tps.FWD_HEADER]
    for first, last, macro, count in tps.FWD_REGIONS:
        chunks = header.split(f"#ifndef {macro}\n{first}\n")[1:]
        bodies = [c[:c.index(f"{last}\n#endif\n")] for c in chunks]
        if macro == "PHASE_NO_ENCODE":
            assert all("L::at(" in b and "* n +" not in b for b in bodies)
        if macro == "PHASE_NO_HEADS":
            assert all("cs + " in b and " * rs]" in b for b in bodies)


@pytest.mark.parametrize("source", tps.FWD_SOURCES)
def test_both_forward_kernels_build_from_the_patched_header(source):
    out = tps.patched_fwd_sources(CSRC)
    assert f'#include "{tps.FWD_HEADER}"' in out[source]
    for header in CSRC.glob("*.cuh"):
        if header.name != tps.FWD_HEADER:
            assert out[header.name] == header.read_text()


@pytest.mark.parametrize("region", range(len(tps.FWD_REGIONS)))
@pytest.mark.parametrize("end", [0, 1])
def test_a_missing_forward_anchor_fails_the_patch(region, end):
    text = (CSRC / tps.FWD_HEADER).read_text()
    anchor = tps.FWD_REGIONS[region][end] + "\n"
    with pytest.raises(ValueError, match="occurs"):
        tps.patched_fwd_header(text.replace(anchor, "", 1))


@pytest.mark.parametrize("variant", sorted(tps.FWD_VARIANTS))
def test_forward_variants_nest(variant):
    """Each forward variant cuts what the one before it cut and one phase
    more, so that differences of their times are the phases' times."""
    order = ["full", "no_heads", "no_encode", "products"]
    flags = tps.FWD_VARIANTS[variant]
    assert len(flags) == order.index(variant)
    if variant != "full":
        before = tps.FWD_VARIANTS[order[order.index(variant) - 1]]
        assert flags[:len(before)] == before
    assert {m for *_, m, _ in tps.FWD_REGIONS} == {
        f[2:] for f in tps.FWD_VARIANTS["products"]}


def test_every_normals_anchor_is_found_in_the_committed_header():
    """6n's split: the walk back is guarded in the weight stream and in
    the consumers (one macro), the IPE's Jacobian on its own; only
    `fused_mip_fwd.cu` is built from that copy, and the forward split's
    copy leaves 6n's regions unguarded."""
    out = tps.patched_fwd_sources(CSRC, normals=True)
    header = out[tps.FWD_HEADER]
    assert header.count("#ifndef PHASE_NO_NORMALS_BWD") == 2
    assert header.count("#ifndef PHASE_NO_JACOBIAN") == 1
    for first, last, macro, count in tps.NORMALS_REGIONS:
        assert header.count(f"#ifndef {macro}\n{first}\n") == count
        assert header.count(f"{last}\n#endif\n") == count
    assert set(out) - {h.name for h in CSRC.glob("*.cuh")} == {
        tps.NORMALS_SOURCE}
    assert f'#include "{tps.FWD_HEADER}"' in out[tps.NORMALS_SOURCE]
    plain = tps.patched_fwd_sources(CSRC)[tps.FWD_HEADER]
    assert "PHASE_NO_NORMALS_BWD" not in plain
    assert "PHASE_NO_JACOBIAN" not in plain


@pytest.mark.parametrize("region", range(len(tps.NORMALS_REGIONS)))
@pytest.mark.parametrize("end", [0, 1])
def test_a_missing_normals_anchor_fails_the_patch(region, end):
    text = (CSRC / tps.FWD_HEADER).read_text()
    anchor = tps.NORMALS_REGIONS[region][end] + "\n"
    assert text.count(anchor) == 1
    with pytest.raises(ValueError, match="occurs"):
        tps.patched_fwd_header(text.replace(anchor, "", 1),
                               tps.NORMALS_REGIONS)


def test_normals_variants_nest():
    """full, then without the Jacobian, then without the walk back too:
    differences of their times are the Jacobian's and the walk back's."""
    v = tps.NORMALS_VARIANTS
    assert list(v) == ["full", "no_jacobian", "forward"]
    assert v["full"] == [] and v["forward"][:1] == v["no_jacobian"]
    assert {m for *_, m, _ in tps.NORMALS_REGIONS} == {
        f[2:] for f in v["forward"]}
