"""Chunk/window planner + multi-window painting differential tests."""
import gzip
import shutil

import numpy as np
import pytest

from relate_tpu.core import painting
from relate_tpu.io import chunking, refpaint


@pytest.fixture(scope="module")
def mw_dir(tmp_path_factory):
    from pathlib import Path
    src = Path(__file__).parent / "golden" / "mw"
    if not src.exists():
        pytest.skip("mw golden fixtures absent")
    out = tmp_path_factory.mktemp("mw")
    for p in src.iterdir():
        if p.suffix == ".gz":
            with gzip.open(p, "rb") as a, open(out / p.stem, "wb") as b:
                shutil.copyfileobj(a, b)
        else:
            shutil.copy(p, out / p.name)
    return out


@pytest.mark.golden
def test_planner_matches_reference(mw_dir, golden_chunk):
    """plan_chunks_and_windows must reproduce the reference's chunk and
    window boundaries byte-for-byte (here with --memory 0.001: 5 chunks,
    4 windows in chunk 0). The default-memory golden chunk_0 is the
    reference's single chunk over the whole example (all 130,862 SNPs), so
    its panel is the example's genotype matrix."""
    plan, wplans = chunking.plan_chunks_and_windows(golden_chunk.G, 0.001)
    ref = chunking.read_reference_parameters(str(mw_dir / "parameters.bin"))
    assert plan.start == ref["start"]
    assert plan.end == ref["end"]
    for c in (0, 1):
        refc = chunking.read_reference_parameters(
            str(mw_dir / f"parameters_c{c}.bin"))
        assert wplans[c].boundaries == refc["boundaries"]


@pytest.mark.golden
def test_stepping_stones_match_reference_interior(mw_dir):
    """Interior stepping-stone checkpoints vs the reference's paint files.

    alpha/beta agree within the reference's lossy RLE codec tolerance
    (1e-3 relative runs, collapsed_matrix.hpp:243). Logscales agree up to
    float32-vs-double accumulation paths (absolute offsets only, which
    cancel in the row-min-normalized distance matrix)."""
    ch = chunking.read_reference_chunk(str(mw_dir / "chunk_0"))
    refc0 = chunking.read_reference_parameters(
        str(mw_dir / "parameters_c0.bin"))
    bounds = np.array(refc0["boundaries"])
    painter = painting.Painter(ch.G, ch.r,
                               painting.PaintingModel(N=ch.N, theta=0.001))
    cps = painter.paint_stepping_stones(bounds)
    assert len(cps) == refc0["num_windows"]
    for w in range(len(cps)):
        recs = refpaint.read_paint_file(str(mw_dir / f"relate_{w}.bin"), ch.N)
        for n, rec in enumerate(recs):
            assert rec.bsb == cps[w].bsb[n]
            assert rec.bse == cps[w].bse[n]
            am = max(rec.alpha.max(), 1e-30)
            bm = max(rec.beta.max(), 1e-30)
            assert np.abs(cps[w].alpha[n] - rec.alpha).max() / am < 2e-3
            assert np.abs(cps[w].beta[n] - rec.beta).max() / bm < 2e-3
            assert abs(cps[w].ls_alpha[n] - rec.ls_alpha) < 1.0
            assert abs(cps[w].ls_beta[n] - rec.ls_beta) < 1.0
