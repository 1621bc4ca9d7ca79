"""tools/torch_phase_split.py's patching of the level kernels' header and
of the forward walk's.

The tool times #3 and #5 with their phases cut out by preprocessor guards
that it writes into a copy of `csrc/level_train.cuh` at string anchors,
and #1 and #6 likewise with a copy of `csrc/fwd_hopper.cuh` (the heads,
the encoding, the epilogue). The timing needs a card; the patching is
string work, checked here against the committed sources, so that an edit
of a header cannot leave a phase in the timed variants silently.
"""

import sys
from pathlib import Path

import pytest

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


@pytest.mark.parametrize("source", tps.SOURCES)
def test_both_level_kernels_build_from_the_patched_header(source):
    out = tps.patched_sources(CSRC)
    assert f'#include "{tps.HEADER}"' in out[source]
    # Every other header is copied unchanged beside it.
    for header in CSRC.glob("*.cuh"):
        if header.name != tps.HEADER:
            assert out[header.name] == header.read_text()


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
