"""Smoke tests: every CLI tool x mode must execute and write its output.

The reference exposes ~50 tool modes across Relate / RelateCoalescentRate /
RelateMutationRate / RelateSelection / RelateExtract / RelateFileFormats /
RelateTreeView; this parametrized suite invokes each of ours on a tiny
synthetic panel so wiring rot (wrong arity, wrong unpacking) fails CI
instead of the first user.
"""
import gzip
import os
import shutil

import numpy as np
import pytest

from relate_tpu.pipeline import cli, tools_cli
from relate_tpu.utils.synth import (synth_panel, write_flat_map,
                                    write_haps_sample)

N, L = 8, 400


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Tiny panel + a finished run_all prefix every tool can consume."""
    d = tmp_path_factory.mktemp("cli")
    G, bp = synth_panel(N, L, seed=3)
    prefix = str(d / "toy")
    write_haps_sample(G, bp, prefix)
    write_flat_map(prefix + ".map", int(bp[-1]))
    # gzip copies for tools that expect .gz
    for ext in (".haps", ".sample"):
        with open(prefix + ext, "rb") as fin, \
                gzip.open(prefix + ext + ".gz", "wb") as fout:
            shutil.copyfileobj(fin, fout)
    with open(d / "pop.poplabels", "w") as f:
        f.write("sample population group sex\n")
        for i in range(N // 2):
            f.write(f"s{i} P{'AB'[i % 2]} G{'AB'[i % 2]} NA\n")
    # ancestor fasta covering all bps
    with open(d / "anc.fasta", "w") as f:
        f.write(">1\n" + "A" * (int(bp[-1]) + 2) + "\n")
    out = str(d / "toyrun")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cli.main(["--mode", "All", "--haps", prefix + ".haps",
                  "--sample", prefix + ".sample", "--map", prefix + ".map",
                  "-o", out, "--seed", "1"])
    finally:
        os.chdir(cwd)
    assert os.path.exists(out + ".anc") and os.path.exists(out + ".mut")
    return {"dir": d, "prefix": prefix, "run": out,
            "poplabels": str(d / "pop.poplabels"),
            "ancestor": str(d / "anc.fasta"), "bp": bp, "G": G}


def _tool(panel, tool, mode, extra=(), inp=None, out_suffix=None):
    out = str(panel["dir"] / f"out_{tool}_{mode}")
    rc = tools_cli.main([tool, "--mode", mode,
                         "-i", inp or panel["run"], "-o", out,
                         *extra])
    assert rc == 0
    return out


# ---------------------------------------------------------------- Relate CLI

def test_relate_stage_modes(panel, tmp_path):
    """Per-stage Relate modes on a fresh working dir (Relate.cpp:60-314)."""
    p = panel["prefix"]
    store = str(tmp_path / "stages")
    cli.main(["--mode", "MakeChunks", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", store])
    cli.main(["--mode", "Paint", "-o", store, "--chunk_index", "0"])
    cli.main(["--mode", "BuildTopology", "-o", store, "--chunk_index", "0",
              "--seed", "1"])
    cli.main(["--mode", "FindEquivalentBranches", "-o", store,
              "--chunk_index", "0"])
    cli.main(["--mode", "PostProcess", "-o", store, "--chunk_index", "0"])
    cli.main(["--mode", "InferBranchLengths", "-o", store,
              "--chunk_index", "0", "--seed", "1"])
    cli.main(["--mode", "CombineSections", "-o", store,
              "--chunk_index", "0"])
    final = str(tmp_path / "final")
    cli.main(["--mode", "Finalize", "-o", final, "--store", store])
    assert os.path.exists(final + ".anc") and os.path.exists(final + ".mut")
    cli.main(["--mode", "Clean", "-o", store])


def test_relate_all_with_painting_override_and_postprocess(panel, tmp_path):
    p = panel["prefix"]
    out = str(tmp_path / "runpp")
    cli.main(["--mode", "All", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", out, "--seed", "1",
              "--painting", "0.001,1", "--postprocess"])
    assert os.path.exists(out + ".anc")


def test_postprocess_with_streamed_feb(panel, tmp_path, monkeypatch):
    """--postprocess with RELATE_TPU_FEB_STREAM_WINDOWS=1 (cache=None for
    every chunk) must not crash (ADVICE r4 high: unconditional
    cache.clear() on a None cache)."""
    monkeypatch.setenv("RELATE_TPU_FEB_STREAM_WINDOWS", "1")
    p = panel["prefix"]
    out = str(tmp_path / "runpp_stream")
    cli.main(["--mode", "All", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", out, "--seed", "1",
              "--postprocess"])
    assert os.path.exists(out + ".anc")


def test_optimize_parameters_writes_opt(panel, tmp_path):
    p = panel["prefix"]
    store = str(tmp_path / "opt_store")
    cli.main(["--mode", "MakeChunks", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", store])
    grid = tmp_path / "grid.txt"
    grid.write_text("0.001\n1.0\n")
    out = str(tmp_path / "opt")
    cli.main(["--mode", "OptimizeParameters", "-o", out, "--store", store,
              "--chunk_index", "0", "--input", str(grid)])
    with open(out + ".opt") as f:
        lines = [x.split() for x in f if x.strip()]
    assert len(lines) == 1 and float(lines[0][0]) == 0.001


def test_finalize_annot_join(panel, tmp_path):
    """--annot joins annotation rows into the final .mut
    (Finalize.cpp:98-183)."""
    annot = tmp_path / "toy.annot"
    with open(annot, "w") as f:
        f.write("upstream_allele;downstream_allele;\n")
        for i in range(L):
            f.write("A;C;\n")
    p = panel["prefix"]
    out = str(tmp_path / "runannot")
    cli.main(["--mode", "All", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", out, "--seed", "1",
              "--annot", str(annot)])
    with open(out + ".mut") as f:
        header = f.readline()
        row = f.readline()
    assert header.count("upstream_allele") == 1
    assert row.rstrip("\n").endswith("A;C;")


# ----------------------------------------------------------- CoalescentRate

@pytest.mark.parametrize("mode,extra", [
    ("EstimatePopulationSize", ()),
    ("CoalRateForTree", ()),
    ("GenerateConstCoalFile", ()),
])
def test_coalescent_rate_modes(panel, mode, extra):
    _tool(panel, "CoalescentRate", mode, extra)


@pytest.mark.parametrize("mode,extra", [
    ("ReEstimateBranchLengths", ()),
    ("SampleBranchLengths", ("--num_samples", "2")),
])
def test_coalescent_rate_mcmc_modes(panel, mode, extra):
    # these require a .coal prior (ReEstimateBranchLengths.cpp:144-232)
    coal = str(panel["dir"] / "const")
    tools_cli.main(["CoalescentRate", "--mode", "GenerateConstCoalFile",
                    "-i", panel["run"], "-o", coal, "-N", "30000"])
    _tool(panel, "CoalescentRate", mode,
          (*extra, "--coal", coal + ".coal"))


# -------------------------------------------------------------- MutationRate

def test_mutation_rate_avg_then_summaries(panel):
    out1 = _tool(panel, "MutationRate", "Avg")
    # genome-level modes consume per-chromosome npz prefixes
    for mode in ("SummarizeForGenome", "Finalize", "FinalizeMutationCount"):
        out = str(panel["dir"] / f"out_MutationRate_{mode}")
        rc = tools_cli.main(["MutationRate", "--mode", mode,
                             "-i", out1, "-o", out])
        assert rc == 0
    rc = tools_cli.main(["MutationRate", "--mode", "XY",
                         "-i", f"{out1},{out1}",
                         "-o", str(panel["dir"] / "out_xy")])
    assert rc == 0


def test_mutation_rate_context_and_density(panel):
    _tool(panel, "MutationRate", "WithContext",
          ("--ancestor", panel["ancestor"]))
    _tool(panel, "MutationRate", "MutationDensity")


# ----------------------------------------------------------------- Selection

@pytest.mark.parametrize("mode", ["Frequency", "Selection", "Quality",
                                  "SDS", "FreqDiff"])
def test_selection_modes(panel, mode):
    _tool(panel, "Selection", mode)


# ------------------------------------------------------------------- Extract

@pytest.mark.parametrize("mode,extra", [
    ("AncToNewick", ("--first_bp", "500", "--last_bp", "100000")),
    ("AncMutForSubregion", ("--first_bp", "500", "--last_bp", "100000")),
    ("RemoveTreesWithFewMutations", ("--threshold", "0.2")),
    ("ExtractDistFromMut", ()),
    ("GetMut", ()),
    ("AncientToModern", ()),
    ("CountMutonBranches", ()),
    ("GetAllBranchesOfMut", ()),
    ("CheckBranchPersistence", ()),
    ("GenerateSNPAnnotationsUsingTree", ()),
    ("UnlinkTips", ("--pop_of_interest", "0,1")),
])
def test_extract_modes(panel, mode, extra):
    _tool(panel, "Extract", mode, extra)


def test_extract_subtrees_for_subpopulation(panel):
    _tool(panel, "Extract", "SubTreesForSubpopulation",
          ("--poplabels", panel["poplabels"], "--pop_of_interest", "GA"))


def test_extract_divide_then_combine(panel):
    out = str(panel["dir"] / "out_div")
    rc = tools_cli.main(["Extract", "--mode", "DivideAncMut",
                         "-i", panel["run"], "-o", out, "--threads", "2"])
    assert rc == 0
    assert os.path.exists(out + "_chr1.anc")
    rc = tools_cli.main(["Extract", "--mode", "CombineAncMut",
                         "-i", panel["run"], "-o", out])
    assert rc == 0
    assert os.path.exists(out + ".anc")
    # metadata in the combined mut must come from the chunks
    from relate_tpu.io import ancmut
    orig = ancmut.read_mut_final(panel["run"] + ".mut")
    comb = ancmut.read_mut_final(out + ".mut")
    assert [m["pos"] for m in comb] == [m["pos"] for m in orig]


def test_extract_map_mutations(panel, tmp_path):
    """MapMutations reads extra SNPs from a second haps pair and merges
    them into the .mut (GetTreeOfInterest.cpp:128-290)."""
    rng = np.random.default_rng(5)
    bp = panel["bp"]
    extra_bp = bp[:20] + 7  # positions strictly between existing SNPs
    Gx = (rng.random((20, N)) < 0.4).astype(np.uint8)
    prefix = str(tmp_path / "extra")
    write_haps_sample(Gx, extra_bp, prefix)
    out = str(tmp_path / "mapped")
    rc = tools_cli.main(["Extract", "--mode", "MapMutations",
                         "-i", panel["run"], "-o", out,
                         "--haps", prefix + ".haps",
                         "--sample", prefix + ".sample"])
    assert rc == 0
    from relate_tpu.io import ancmut
    merged = ancmut.read_mut_final(out + ".mut")
    assert len(merged) == L + 20
    pos = [m["pos"] for m in merged]
    assert pos == sorted(pos)


# --------------------------------------------------------------- FileFormats

def test_fileformats_generate_snp_annotations(panel):
    out = _tool(panel, "FileFormats", "GenerateSNPAnnotations",
                ("--ancestor", panel["ancestor"],
                 "--poplabels", panel["poplabels"]),
                inp=panel["prefix"])
    with open(out + ".annot") as f:
        header = f.readline()
        row1 = f.readline()
    assert header.startswith("upstream_allele;downstream_allele;")
    assert row1.count(";") >= 2


@pytest.mark.parametrize("mode,extra", [
    ("RemoveNonBiallelicSNPs", ()),
    ("FlipHapsUsingAncestor", ("--ancestor", "ANCESTOR")),
])
def test_fileformats_haps_modes(panel, mode, extra):
    extra = tuple(panel["ancestor"] if e == "ANCESTOR" else e for e in extra)
    _tool(panel, "FileFormats", mode, extra, inp=panel["prefix"])


def test_fileformats_tree_sequence(panel):
    out = _tool(panel, "FileFormats", "ConvertToTreeSequence")
    assert os.path.exists(out + ".trees")


# ------------------------------------------------------------------ TreeView

@pytest.mark.parametrize("mode", ["TreeView", "TreeViewSample",
                                  "MutationsOnBranches",
                                  "BranchesBelowMutation"])
def test_treeview_modes(panel, mode):
    _tool(panel, "TreeView", mode, ("--bp_of_interest", "5000"))


def test_multi_chromosome_coalescent_rate(panel):
    """--first_chr/--last_chr loop + genome summarize vs the single-input
    run (RelateCoalescentRate.cpp:57-79): per-chr sufficient statistics
    summed in memory must reproduce the whole-genome rates up to the
    chunk-edge half-dist corrections."""
    # two "chromosomes" from DivideAncMut
    out = str(panel["dir"] / "mc")
    tools_cli.main(["Extract", "--mode", "DivideAncMut",
                    "-i", panel["run"], "-o", out, "--threads", "2"])
    tools_cli.main(["CoalescentRate", "--mode", "EstimatePopulationSize",
                    "-i", out, "-o", out + "_multi",
                    "--first_chr", "1", "--last_chr", "2"])
    tools_cli.main(["CoalescentRate", "--mode", "EstimatePopulationSize",
                    "-i", panel["run"], "-o", out + "_single"])
    from relate_tpu.evaluate.coalrate import read_coal
    _, e1, r1 = read_coal(out + "_multi.coal")
    _, e2, r2 = read_coal(out + "_single.coal")
    np.testing.assert_allclose(e1, e2)
    ok = np.isfinite(r1) & np.isfinite(r2) & (r2 > 0)
    assert ok.sum() > 3
    np.testing.assert_allclose(r1[ok], r2[ok], rtol=0.05)


def test_multi_chromosome_mutation_rate(panel):
    out = str(panel["dir"] / "mc2")
    tools_cli.main(["Extract", "--mode", "DivideAncMut",
                    "-i", panel["run"], "-o", out, "--threads", "2"])
    tools_cli.main(["MutationRate", "--mode", "Avg",
                    "-i", out, "-o", out + "_mr",
                    "--first_chr", "1", "--last_chr", "2"])
    import os
    assert os.path.exists(out + "_mr.rate")


def test_run_all_threads_identical(tmp_path, monkeypatch):
    """--threads (the RelateParallel.sh thread pool, SURVEY §2.5) must be
    byte-identical to the sequential chunk order. Chunk overlap constants
    are shrunk so a 600-SNP panel splits into multiple chunks."""
    from relate_tpu.io import chunking
    from relate_tpu.pipeline import relate
    from relate_tpu.utils.synth import (synth_panel, write_flat_map,
                                        write_haps_sample)
    monkeypatch.setattr(chunking, "OVERLAP", 60)
    monkeypatch.setattr(chunking, "MERGE_DISCARD", 30)
    monkeypatch.setattr(relate, "MERGE_DISCARD", 30)
    monkeypatch.setattr(chunking, "MAX_WINDOWS_PER_CHUNK", 4)
    G, bp = synth_panel(8, 600, seed=11)
    prefix = str(tmp_path / "p")
    write_haps_sample(G, bp, prefix)
    write_flat_map(prefix + ".map", int(bp[-1]))

    mem = 1e-5   # tiny budget -> several chunks on a 600-SNP panel
    plan, _ = chunking.plan_chunks_and_windows(G, mem)
    assert plan.num_chunks > 1   # else the pool never engages

    out1 = str(tmp_path / "seq")
    out2 = str(tmp_path / "par")
    relate.run_all(prefix + ".haps", prefix + ".sample", prefix + ".map",
                   out1, seed=1, verbose=False, threads=1, memory_gb=mem)
    relate.run_all(prefix + ".haps", prefix + ".sample", prefix + ".map",
                   out2, seed=1, verbose=False, threads=3, memory_gb=mem)
    with open(out1 + ".anc") as a, open(out2 + ".anc") as b:
        assert a.read() == b.read()
    with open(out1 + ".mut") as a, open(out2 + ".mut") as b:
        assert a.read() == b.read()


def test_run_all_two_host_processes_identical(tmp_path):
    """The multi-process branch of run_all: two REAL OS processes,
    coordinated only through the shared artifact store (host identity via
    RELATE_TPU_NUM_HOSTS/HOST_ID — the filesystem-launch model replacing
    the reference's job arrays), must produce the same final .anc/.mut as
    a single-host run, byte for byte. Host 1 starts FIRST so the
    plan.json wait (atomic, written last) is actually exercised; chunk
    overlap constants are shrunk so the panel splits into multiple chunks
    round-robined across the two hosts."""
    import subprocess
    import sys
    from relate_tpu.io import chunking
    from relate_tpu.pipeline import relate
    from relate_tpu.utils.synth import (synth_panel, write_flat_map,
                                        write_haps_sample)
    G, bp = synth_panel(8, 600, seed=11)
    prefix = str(tmp_path / "p")
    write_haps_sample(G, bp, prefix)
    write_flat_map(prefix + ".map", int(bp[-1]))

    driver = tmp_path / "host_driver.py"
    driver.write_text(
        "import sys\n"
        f"sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})\n"
        "from relate_tpu.io import chunking\n"
        "from relate_tpu.pipeline import relate\n"
        "chunking.OVERLAP = 60\n"
        "chunking.MERGE_DISCARD = 30\n"
        "relate.MERGE_DISCARD = 30\n"
        "chunking.MAX_WINDOWS_PER_CHUNK = 4\n"
        f"relate.run_all({prefix + '.haps'!r}, {prefix + '.sample'!r}, "
        f"{prefix + '.map'!r}, sys.argv[1], seed=1, verbose=False, "
        "memory_gb=1e-5)\n")

    out2 = str(tmp_path / "twohost")
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "RELATE_TPU_NUM_HOSTS": "2",
                "RELATE_TPU_BARRIER_TIMEOUT_S": "600"})
    env.pop("XLA_FLAGS", None)
    procs = []
    for host in (1, 0):          # host 1 first: exercises the plan wait
        e = dict(env)
        e["RELATE_TPU_HOST_ID"] = str(host)
        procs.append(subprocess.Popen(
            [sys.executable, str(driver), out2], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=570)
        assert p.returncode == 0, out.decode(errors="replace")[-2000:]

    # single-host reference (in-process, same shrunken constants)
    import contextlib
    with contextlib.ExitStack() as stack:
        orig = (chunking.OVERLAP, chunking.MERGE_DISCARD,
                relate.MERGE_DISCARD, chunking.MAX_WINDOWS_PER_CHUNK)
        stack.callback(lambda: (setattr(chunking, "OVERLAP", orig[0]),
                                setattr(chunking, "MERGE_DISCARD", orig[1]),
                                setattr(relate, "MERGE_DISCARD", orig[2]),
                                setattr(chunking, "MAX_WINDOWS_PER_CHUNK",
                                        orig[3])))
        chunking.OVERLAP = 60
        chunking.MERGE_DISCARD = 30
        relate.MERGE_DISCARD = 30
        chunking.MAX_WINDOWS_PER_CHUNK = 4
        plan, _ = chunking.plan_chunks_and_windows(G, 1e-5)
        assert plan.num_chunks > 1   # else host 1 had no work
        out1 = str(tmp_path / "onehost")
        relate.run_all(prefix + ".haps", prefix + ".sample",
                       prefix + ".map", out1, seed=1, verbose=False,
                       memory_gb=1e-5)
    for ext in (".anc", ".mut"):
        with open(out1 + ext, "rb") as a, open(out2 + ext, "rb") as b:
            assert a.read() == b.read(), f"{ext} differs across hosts"


def test_streamed_feb_identical(tmp_path, monkeypatch):
    """The streaming FindEquivalentBranches path (at most two windows
    resident — VERDICT r3 weak #8) must write byte-identical per-window
    trees to the in-memory path on a multi-window chunk."""
    import shutil as _sh
    from relate_tpu.io import chunking
    from relate_tpu.pipeline import cli, relate
    from relate_tpu.utils.synth import (synth_panel, write_flat_map,
                                        write_haps_sample)
    monkeypatch.setattr(chunking, "OVERLAP", 60)
    monkeypatch.setattr(chunking, "MERGE_DISCARD", 30)
    monkeypatch.setattr(relate, "MERGE_DISCARD", 30)
    G, bp = synth_panel(8, 500, seed=13)
    prefix = str(tmp_path / "p")
    write_haps_sample(G, bp, prefix)
    write_flat_map(prefix + ".map", int(bp[-1]))
    store = str(tmp_path / "st")
    cli.main(["--mode", "MakeChunks", "--haps", prefix + ".haps",
              "--sample", prefix + ".sample", "--map", prefix + ".map",
              "-o", store, "--memory", "3e-6"])
    plan, wplans = relate.ArtifactStore(store).load_plan()
    W = wplans[0].num_windows
    assert W >= 3, W             # need a real multi-window chunk
    cli.main(["--mode", "Paint", "-o", store, "--chunk_index", "0"])
    cli.main(["--mode", "BuildTopology", "-o", store, "--chunk_index", "0",
              "--seed", "1"])
    snap = str(tmp_path / "snap")
    _sh.copytree(store, snap)

    st = relate.ArtifactStore(store)
    monkeypatch.setenv("RELATE_TPU_FEB_STREAM_WINDOWS", "9999")
    relate.find_equivalent_branches(st, 0)          # in-memory path
    mem = {w: open(st.path("chunk_0", f"trees_{w}.anc"), "rb").read()
           for w in range(W)}
    _sh.rmtree(store)
    _sh.copytree(snap, store)
    monkeypatch.setenv("RELATE_TPU_FEB_STREAM_WINDOWS", "1")
    relate.find_equivalent_branches(st, 0)          # streamed path
    for w in range(W):
        got = open(st.path("chunk_0", f"trees_{w}.anc"), "rb").read()
        assert got == mem[w], f"window {w} differs under streaming"


def test_atomic_write_never_exposes_partial(tmp_path):
    """ancmut.atomic_write must leave either no file or the complete file —
    never a partial one (the property the multi-host barrier relies on)."""
    from relate_tpu.io.ancmut import atomic_write
    target = tmp_path / "artifact.bin"
    with pytest.raises(RuntimeError):
        with atomic_write(str(target), "wb") as f:
            f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert not target.exists()
    assert not list(tmp_path.glob("artifact.bin.tmp.*"))
    with atomic_write(str(target), "wb") as f:
        f.write(b"complete")
    assert target.read_bytes() == b"complete"


def test_crash_recovery_restart_from_stage(panel, tmp_path):
    """Stage-level restartability (the reference's recovery model,
    Relate.cpp:33-35 + Clean.cpp): a staged run equals run_all, and after a
    simulated crash (BuildTopology artifacts lost) re-running from that
    stage onward reproduces the identical final output."""
    p = panel["prefix"]
    store = str(tmp_path / "stages")
    cli.main(["--mode", "MakeChunks", "--haps", p + ".haps", "--sample",
              p + ".sample", "--map", p + ".map", "-o", store])
    cli.main(["--mode", "Paint", "-o", store, "--chunk_index", "0"])

    def from_topology(final):
        cli.main(["--mode", "BuildTopology", "-o", store,
                  "--chunk_index", "0", "--seed", "1"])
        cli.main(["--mode", "FindEquivalentBranches", "-o", store,
                  "--chunk_index", "0"])
        cli.main(["--mode", "InferBranchLengths", "-o", store,
                  "--chunk_index", "0", "--seed", "1"])
        cli.main(["--mode", "CombineSections", "-o", store,
                  "--chunk_index", "0"])
        cli.main(["--mode", "Finalize", "-o", final, "--store", store])

    final1 = str(tmp_path / "final1")
    from_topology(final1)
    # staged flow == run_all (same seeds/defaults)
    with open(final1 + ".anc") as a, open(panel["run"] + ".anc") as b:
        assert a.read() == b.read()
    with open(final1 + ".mut") as a, open(panel["run"] + ".mut") as b:
        assert a.read() == b.read()

    # crash: every BuildTopology artifact of chunk 0 is lost
    for f in os.listdir(os.path.join(store, "chunk_0")):
        if f.startswith(("trees_", "muts_", "combined")):
            os.remove(os.path.join(store, "chunk_0", f))
    final2 = str(tmp_path / "final2")
    from_topology(final2)
    with open(final1 + ".anc") as a, open(final2 + ".anc") as b:
        assert a.read() == b.read()
    with open(final1 + ".mut") as a, open(final2 + ".mut") as b:
        assert a.read() == b.read()
