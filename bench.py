"""Benchmark: painting + tree-build throughput and pipeline e2e wall clock.

Prints JSON result lines with the primary metric (combined painting+
tree-build SNPs/s per chip — BASELINE.json's metric) plus per-stage
detail fields. A line is (re-)emitted after EVERY completed stage, each a
complete superset of the previous one, so an external timeout can never
erase finished work — the last JSON line on stdout is always the most
complete result.

Workload: N=256 haplotypes x L=30,000 SNPs (coalescent-simulated panel,
seed 7) — the full all-vs-all painting posterior (stepping stones + window
repaint) followed by BuildTopology over the same window, exactly the two
stages the reference splits into `--mode Paint` and `--mode BuildTopology`.

Baselines (reference C++ binary built from its source with default
flags, single core, measured on this machine — BASELINE_MEASURED.json,
scripts/measure_reference.py):
- N=256  Paint:          3.08 s  => 9,740 SNPs/s (round-1, kept)
- N=256  BuildTopology: 54.13 s  =>   554 SNPs/s
- N=256  --mode All:   170.5 s   (round-5 re-measurement; the round-1
  270.7 s was a different machine state — vs_baseline uses 170.5)
- N=256  RelateParallel --threads 8: 208.5 s — but this box has only
  2 CPU cores, so the honest 8-core bound is 170.5/8 = 21.3 s (ideal)
- N=2048 Paint 189.9 SNPs/s; BuildTopology 11.81 SNPs/s (measured)
- N=5008 Paint 25.67 SNPs/s; BuildTopology 1.438 SNPs/s (measured)

Runs on a GPU only: with no GPU it exits non-zero without a result. A
stage that raises ends the run with a non-zero exit; later stages are
skipped when the wall-clock budget (RELATE_TPU_BENCH_BUDGET_S, default
900 s) runs low. Device work is timed to ``block_until_ready``.
"""
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_PAINT_SNPS_PER_S = 9740.0     # C++ Relate --mode Paint, 1 core
BASELINE_BT_SNPS_PER_S = 30000.0 / 54.13   # C++ --mode BuildTopology
BASELINE_COMBINED_SNPS_PER_S = 30000.0 / (3.08 + 54.13)
BASELINE_E2E_S = 170.5                 # C++ --mode All, same panel,
#                                        re-measured round 5 on this box
BASELINE_E2E_8CORE_IDEAL_S = 170.5 / 8.0   # perfect-scaling 8-core bound
# measured single-core reference at scale (BASELINE_MEASURED.json)
BASE_N2048_PAINT = 189.94
BASE_N2048_BT = 11.807
BASE_N5008_PAINT = 25.67
BASE_N5008_BT = 1.438
N, L = 256, 30000

RESULT = {
    "metric": "paint_plus_treebuild_snps_per_s_per_chip",
    "value": 0.0,
    "unit": "SNPs/s (N=256 painting posterior + BuildTopology)",
    "vs_baseline": 0.0,
}
_t_start = time.time()


def _note(msg):
    print("[bench %6.1fs] %s" % (time.time() - _t_start, msg),
          file=sys.stderr, flush=True)


def _emit():
    from relate_tpu.utils import trace
    RESULT["bench_wall_s"] = round(time.time() - _t_start, 1)
    if trace.STAGES:
        RESULT["e2e_stages"] = {r["stage"]: r["wall_s"] for r in trace.STAGES}
    print(json.dumps(RESULT), flush=True)


def _prewarm_mcmc(N):
    """Compile the MCMC chain programs for the e2e workload's bucket shape
    (B=chain_batch_cap(M) — the SAME bucket run_mcmc pads production
    slices to; a smaller prewarm bucket would leave the big compile inside
    the timed region) OUTSIDE the timed region: the e2e number measures
    steady-state pipeline throughput, matching how the paint/treebuild
    stages are warmed (and how the reference binary pays zero compile)."""
    import numpy as np

    from relate_tpu.core import mcmc
    from relate_tpu.core.trees import Tree, children_from_parent

    M = 2 * N - 1
    parent = np.empty(M, np.int32)
    parent[-1] = -1
    # caterpillar: leaves 0..N-1; internal node N+t joins node t+1
    for t in range(N - 1):
        parent[N + t] = N + t + 1 if t < N - 2 else -1
    parent[0] = N
    for i in range(1, N):
        parent[i] = N + i - 1
    parent[M - 1] = -1
    cl, cr = children_from_parent(parent)
    tr = Tree(parent=parent, child_left=cl, child_right=cr)
    tr.num_events = np.ones(M, np.float32)
    tr.SNP_begin = np.zeros(M, np.int32)
    tr.SNP_end = np.full(M, 100, np.int32)
    trees = [tr] * mcmc.chain_batch_cap(M)
    dist = np.ones(101, np.float64)
    mcmc.run_mcmc(trees, dist, 101, seed=0, max_rounds=1)


def _stages(budget):
    import jax

    from relate_tpu.core import painting, topology_device
    from relate_tpu.utils import synth

    devs = jax.devices()
    _note("jax devices: %s" % (devs,))
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {devs[0].platform}")
    RESULT["device"] = {"platform": devs[0].platform,
                        "kind": devs[0].device_kind, "count": len(devs)}

    G, bp = synth.synth_panel(N, L)
    r = np.full(L, 2500 * 0.5e-8 * 500)
    rpos = np.cumsum(r)
    state = np.ones(L, dtype=np.int32)
    model = painting.PaintingModel(N=N, theta=0.001)
    painter = painting.Painter(G, r, model)

    force = jax.block_until_ready

    # ---- painting: stones + window repaint --------------------------------
    cps = painter.paint_stepping_stones(np.array([0, L]))
    out = painter.repaint(cps[0])
    force(out.topology)                    # warm up (compile)
    _note("paint warmup done")
    reps = 5
    t0 = time.time()
    for _ in range(reps):
        out = painter.repaint(cps[0])
    force(out.topology)
    paint_s = (time.time() - t0) / reps
    paint_snps = L / paint_s
    _note("paint: %.3f s/window (%.0f SNPs/s)" % (paint_s, paint_snps))

    RESULT["metric"] = "painting_snps_per_s_per_chip"
    RESULT["value"] = round(paint_snps, 1)
    RESULT["unit"] = "SNPs/s (N=256 all-vs-all painting posterior)"
    RESULT["vs_baseline"] = round(paint_snps / BASELINE_PAINT_SNPS_PER_S, 3)
    RESULT["painting_snps_per_s"] = round(paint_snps, 1)
    RESULT["painting_vs_baseline"] = RESULT["vs_baseline"]
    _emit()

    # ---- tree build: full-window BuildTopology ----------------------------
    # warm-up run at the SAME padded size bucket as the timed run (a smaller
    # prefix would compile a different bucket and leave the big compile
    # inside the timed region)
    kernel = topology_device.make_section_kernel(model.theta, N, L, 1)
    topology_device.build_topology_section_device(
        painter, cps[0], G, rpos, state, bp, 0, L - 1, seed=1, kernel=kernel)
    _note("treebuild warmup done")
    t0 = time.time()
    res = topology_device.build_topology_section_device(
        painter, cps[0], G, rpos, state, bp, 0, L - 1, seed=1,
        kernel=kernel)
    bt_s = time.time() - t0
    bt_snps = L / bt_s
    num_trees = len(res.anc.seq)
    _note("treebuild: %.2f s (%.0f SNPs/s, %d trees)"
          % (bt_s, bt_snps, num_trees))

    combined_s = L / paint_snps + bt_s
    combined_snps = L / combined_s

    RESULT["metric"] = "paint_plus_treebuild_snps_per_s_per_chip"
    RESULT["value"] = round(combined_snps, 1)
    RESULT["unit"] = "SNPs/s (N=256 painting posterior + BuildTopology)"
    RESULT["vs_baseline"] = round(
        combined_snps / BASELINE_COMBINED_SNPS_PER_S, 3)
    RESULT["treebuild_snps_per_s"] = round(bt_snps, 1)
    RESULT["treebuild_vs_baseline"] = round(
        bt_snps / BASELINE_BT_SNPS_PER_S, 3)
    RESULT["num_trees"] = num_trees
    _emit()

    # ---- e2e: run_all on the same panel vs C++ --mode All -----------------
    # only attempted when enough budget remains (the combined line above is
    # already on stdout)
    remaining = budget - (time.time() - _t_start)
    if (os.environ.get("RELATE_TPU_BENCH_E2E", "1") != "0"
            and remaining > 100.0):
        from relate_tpu.pipeline import relate
        from relate_tpu.utils import trace
        from relate_tpu.utils.synth import write_flat_map, write_haps_sample
        _prewarm_mcmc(N)
        _note("mcmc prewarm done")
        d = tempfile.mkdtemp(prefix="relate_bench_")
        try:
            prefix = os.path.join(d, "panel")
            write_haps_sample(G, bp, prefix)
            write_flat_map(prefix + ".map", int(bp[-1]))
            trace.STAGES.clear()
            t0 = time.time()
            relate.run_all(prefix + ".haps", prefix + ".sample",
                           prefix + ".map", os.path.join(d, "out"),
                           seed=1,
                           verbose=os.environ.get(
                               "RELATE_TPU_BENCH_VERBOSE") == "1")
            e2e_s = time.time() - t0
            RESULT["e2e_s"] = round(e2e_s, 1)
            RESULT["e2e_vs_baseline"] = round(BASELINE_E2E_S / e2e_s, 3)
            RESULT["e2e_vs_8core_ideal"] = round(
                BASELINE_E2E_8CORE_IDEAL_S / e2e_s, 3)
            # per-stage wall seconds
            RESULT["e2e_stages"] = {
                r["stage"]: r["wall_s"] for r in trace.STAGES}
            _note("e2e: %.1f s  stages: %s" % (e2e_s, RESULT["e2e_stages"]))
            _emit()
        finally:
            shutil.rmtree(d, ignore_errors=True)

    # ---- flagship-scale points: N=2048 and N=5008 -------------------------
    # measured against the single-core reference numbers in
    # BASELINE_MEASURED.json
    def _hbm():
        st = jax.local_devices()[0].memory_stats()
        return "%.1f/%.1fGB" % (st["bytes_in_use"] / 1e9,
                                st["bytes_limit"] / 1e9)

    def _bigN_point(N2, Lp, seed, tag, base_paint, base_bt, max_windows):
        from relate_tpu.core import topology_device
        from relate_tpu.io import chunking
        G2, bp2 = synth.synth_panel(N2, Lp, seed=seed)
        # windows from the real memory model, budget sized from device
        # memory (no hand-tuned --memory)
        _, wplans = chunking.plan_chunks_and_windows(G2, None)
        bounds_all = np.asarray(wplans[0].boundaries)
        bounds = bounds_all[: min(max_windows + 1, len(bounds_all))]
        L2 = int(bounds[-1])
        G2 = G2[:L2]
        bp2 = bp2[:L2]
        r2 = np.full(L2, 2500 * 0.5e-8 * 500)
        rpos2 = np.cumsum(r2)
        state2 = np.ones(L2, dtype=np.int32)
        model2 = painting.PaintingModel(N=N2, theta=0.001)
        painter2 = painting.Painter(G2, r2, model2)
        RESULT[f"{tag}_paint_impl"] = ("triton_kernel" if painter2.use_kernel
                                       else "xla_scan")
        RESULT[f"{tag}_merge_impl"] = (
            "triton_kernel" if topology_device.use_merge_kernel()
            else "xla_scan")
        w_len = int(bounds[1] - bounds[0])
        _note("%s panel ready; first window %d SNPs, %d of %d windows "
              "(L2=%d)" % (tag, w_len, len(bounds) - 1,
                           len(bounds_all) - 1, L2))
        t0 = time.time()
        cps2 = painter2.paint_stepping_stones(bounds)
        stones_cold = time.time() - t0
        _note("%s stones cold %.1fs (hbm %s)" % (tag, stones_cold, _hbm()))
        t0 = time.time()
        cps2 = painter2.paint_stepping_stones(bounds)
        stones_s = time.time() - t0
        stones_snps = int(bounds[-1] - bounds[0])
        out2 = painter2.repaint(cps2[0])
        force(out2.topology)
        del out2
        t0 = time.time()
        out2 = painter2.repaint(cps2[0])
        force(out2.topology)
        rep_s = time.time() - t0
        del out2
        paint2_snps = w_len / rep_s
        RESULT[f"{tag}_paint_stones_s"] = round(stones_s, 2)
        RESULT[f"{tag}_paint_stones_snps_per_s"] = round(
            stones_snps / stones_s, 1)
        RESULT[f"{tag}_paint_stones_vs_1core"] = round(
            stones_snps / stones_s / base_paint, 2)
        RESULT[f"{tag}_paint_snps_per_s"] = round(paint2_snps, 1)
        _note("%s paint: stones %.1fs warm (%d SNPs, %.1fx 1-core ref), "
              "repaint %.2fs/window (%.0f SNPs/s)"
              % (tag, stones_s, stones_snps,
                 stones_snps / stones_s / base_paint, rep_s, paint2_snps))
        _emit()

        S2 = min(1024, w_len - 1)
        kern2 = topology_device.make_section_kernel(0.001, N2, L2, 1)
        t0 = time.time()
        res2 = topology_device.build_topology_section_device(
            painter2, cps2[0], G2, rpos2, state2, bp2,
            int(bounds[0]), int(bounds[0]) + S2 - 1, seed=1, kernel=kern2)
        bt2_s = time.time() - t0
        # first call includes compile; steady-state is the second call
        t0 = time.time()
        res2 = topology_device.build_topology_section_device(
            painter2, cps2[0], G2, rpos2, state2, bp2,
            int(bounds[0]), int(bounds[0]) + S2 - 1, seed=1, kernel=kern2)
        bt2_warm = time.time() - t0
        RESULT[f"{tag}_treebuild_snps_per_s"] = round(S2 / bt2_warm, 1)
        RESULT[f"{tag}_treebuild_vs_1core"] = round(
            S2 / bt2_warm / base_bt, 2)
        RESULT[f"{tag}_treebuild_num_trees"] = len(res2.anc.seq)
        peak = jax.local_devices()[0].memory_stats()["peak_bytes_in_use"]
        RESULT[f"{tag}_peak_device_mb"] = round(peak / 1e6, 1)
        _note("%s treebuild: %.1fs cold, %.1fs warm (%d SNPs, %d trees, "
              "%.1fx 1-core ref)" % (tag, bt2_s, bt2_warm, S2,
                                     len(res2.anc.seq),
                                     S2 / bt2_warm / base_bt))
        _emit()

    remaining = budget - (time.time() - _t_start)
    if (os.environ.get("RELATE_TPU_BENCH_N2048", "1") != "0"
            and remaining > 150.0):
        _bigN_point(2048, L, 9, "n2048", BASE_N2048_PAINT, BASE_N2048_BT, 9)
    remaining = budget - (time.time() - _t_start)
    if (os.environ.get("RELATE_TPU_BENCH_N5008", "1") != "0"
            and remaining > 200.0):
        _bigN_point(5008, 12000, 11, "n5008", BASE_N5008_PAINT,
                    BASE_N5008_BT, 4)

    # ---- MCMC at large M: chain-batch points -------------------------------
    def _mcmc_point(Nn, tag):
        from relate_tpu.core import mcmc
        from relate_tpu.core.treebuilder import quick_build
        M = 2 * Nn - 1
        rng = np.random.default_rng(3)
        A = rng.random((Nn, Nn)).astype(np.float32) * 50
        d = A + A.T
        np.fill_diagonal(d, 0)
        tr = quick_build(d, None, theta=0.001, seed=1)
        tr.num_events = rng.poisson(1.0, M).astype(np.float32)
        tr.SNP_begin = np.zeros(M, np.int32)
        tr.SNP_end = np.full(M, 400, np.int32)
        B = mcmc.chain_batch_cap(M)
        trees = [tr] * B
        dist = np.ones(401, np.float64)
        mcmc.run_mcmc(trees, dist, 401, seed=0, max_rounds=1)  # warm
        t0 = time.time()
        mcmc.run_mcmc(trees, dist, 401, seed=0)
        wall = time.time() - t0
        RESULT[f"{tag}_chains_per_program"] = B
        RESULT[f"{tag}_batch_wall_s"] = round(wall, 2)
        RESULT[f"{tag}_trees_per_s"] = round(B / wall, 2)
        _note("%s: %d chains converged in %.1fs (%.2f trees/s)"
              % (tag, B, wall, B / wall))
        _emit()

    remaining = budget - (time.time() - _t_start)
    if (os.environ.get("RELATE_TPU_BENCH_MCMC", "1") != "0"
            and remaining > 180.0):
        _mcmc_point(2048, "mcmc_m4095")
    remaining = budget - (time.time() - _t_start)
    if (os.environ.get("RELATE_TPU_BENCH_MCMC", "1") != "0"
            and remaining > 240.0):
        _mcmc_point(5008, "mcmc_m10015")


def main():
    budget = float(os.environ.get("RELATE_TPU_BENCH_BUDGET_S", "900"))
    _stages(budget)
    _emit()


if __name__ == "__main__":
    main()
