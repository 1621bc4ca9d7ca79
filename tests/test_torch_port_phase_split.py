"""tools/torch_phase_split.py's patching of the level kernels' header.

The tool times #3 and #5 with their phases cut out by preprocessor guards
that it writes into a copy of `csrc/level_train.cuh` at string anchors. The
timing needs a card; the patching is string work, checked here against the
committed sources, so that an edit of the header cannot leave a phase in
the timed variants silently.
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
