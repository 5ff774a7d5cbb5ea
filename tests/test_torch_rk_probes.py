"""The source edits of chip_smoke.py's kernel-12 breakdown (--rk-breakdown):
each probe is an edited copy of csrc/rk_cg.cu, so an edit of the kernel must
not quietly void one.  No JAX, no card."""

import importlib.util
import os
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = Path(REPO) / "lbm_tpu_torch" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", ["whole", "stage 1 alone", "stages 1 and 2", "no pull stores",
                                   "no collision"])
def test_rk_breakdown_probe_applies_to_the_source(label):
    """Every edit of the tile's probe finds its text in today's
    csrc/rk_cg.cu, and every probe but "whole" changes the source."""
    cs = _chip_smoke()
    sources = cs.rk_probe_sources(CSRC)
    assert set(sources) == set(cs.RK_PROBES)
    assert (sources[label] == sources["whole"]) == (label == "whole")


@pytest.mark.parametrize("design", ["staged in float32 too", "loads in float64 too",
                                    "stage 1 unrolled", "stage 2 unrolled", "one copy group",
                                    "taps once a cell"])
def test_rk_design_applies_to_the_source(design):
    """Every edit of each other design of kernel 12 (RK_DESIGNS) finds its
    text in today's csrc/rk_cg.cu and changes it."""
    cs = _chip_smoke()
    sources = cs.rk_probe_sources(CSRC, cs.RK_DESIGNS)
    assert set(sources) == set(cs.RK_DESIGNS)
    assert sources[design] != (CSRC / "rk_cg.cu").read_text()


def test_rk_breakdown_refuses_a_stale_edit(tmp_path):
    """A probe whose text the source no longer holds stops the run."""
    cs = _chip_smoke()
    call = "collide_cell<T, EDGE>(q, plane, 0, p, s_af, w, gr, gc, R, cols, coll);"
    text = (CSRC / "rk_cg.cu").read_text()
    assert call in text
    (tmp_path / "rk_cg.cu").write_text(text.replace(call, call.replace("coll)", "out)")))
    with pytest.raises(RuntimeError, match="no longer holds"):
        cs.rk_probe_sources(tmp_path)
