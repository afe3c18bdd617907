"""The Relate pipeline: MakeChunks -> Paint -> BuildTopology ->
FindEquivalentBranches -> InferBranchLengths -> CombineSections -> Finalize.

Behavioral reference: ``include/pipeline/Relate.cpp`` (mode dispatch :60-314,
All at :257-287) and the per-mode sources. Stages communicate through the
ArtifactStore (filesystem), mirroring the reference's restartable staged-file
design; each stage is independently callable (resume = rerun a stage).

Device mapping: Paint and BuildTopology run their device work batched per
window; InferBranchLengths runs one vmapped MCMC chain batch per section;
chunks are the data-parallel (multi-host) axis.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional

import numpy as np

from ..core import mcmc, painting, topology
from ..core.branch_association import (associate_trees,
                                       branch_association_many)
from ..core.trees import AncesTree, MarginalTree
from ..io import ancmut, chunking
from ..io import haps as hio
from ..io.chunking import ArtifactStore, MERGE_DISCARD


def make_chunks(haps_path: str, sample_path: str, map_path: str, outdir: str,
                memory_gb=None, dist_path: Optional[str] = None,
                use_transitions: bool = True,
                sample_ages_path: Optional[str] = None) -> chunking.ChunkPlan:
    data = hio.read_haps(haps_path, sample_path)
    gmap = hio.read_map(map_path)
    dist = hio.read_dist_file(dist_path, data.bp) if dist_path else None
    store = ArtifactStore(outdir)
    ages = None
    if sample_ages_path:
        ages = hio.read_sample_ages(sample_ages_path, data.N)
    return store.make_chunks(data, gmap, memory_gb, dist, use_transitions,
                             ages)


def _painter_for(store: ArtifactStore, c: int, theta: float):
    ch = store.load_chunk(c)
    model = painting.PaintingModel(N=ch.N, theta=theta)
    return ch, painting.Painter(ch.G, ch.r, model)


def paint(store: ArtifactStore, c: int, theta: float = 0.001,
          rho_scale: float = 1.0, mesh=None, cache: Optional[dict] = None):
    """Compute and persist stepping-stone checkpoints for all windows of a
    chunk (pipeline/Paint.cpp equivalent; npz instead of RLE .bin).

    ``mesh``: optional device mesh; the painting target axis is sharded
    over it. With a ``cache``, the in-memory checkpoints (device slabs
    where retained) are handed to build_topology so sections skip both the
    npz reload AND the host->device re-upload."""
    ch = store.load_chunk(c)
    r = ch.r * rho_scale
    model = painting.PaintingModel(N=ch.N, theta=theta)
    painter = painting.Painter(ch.G, r, model, mesh=mesh)
    cps = painter.paint_stepping_stones(np.asarray(ch.windows.boundaries))
    os.makedirs(store.path(f"chunk_{c}"), exist_ok=True)
    for w, cp in enumerate(cps):
        np.savez_compressed(store.path(f"chunk_{c}", f"paint_{w}.npz"),
                            alpha=cp.alpha, ls_alpha=cp.ls_alpha, bsb=cp.bsb,
                            beta=cp.beta, ls_beta=cp.ls_beta, bse=cp.bse)
    if cache is not None:
        cache[("cps", c)] = cps


def load_checkpoint(store: ArtifactStore, c: int, w: int):
    z = np.load(store.path(f"chunk_{c}", f"paint_{w}.npz"))
    return painting.Checkpoint(alpha=z["alpha"], ls_alpha=z["ls_alpha"],
                               bsb=z["bsb"], beta=z["beta"],
                               ls_beta=z["ls_beta"], bse=z["bse"])


def build_topology(store: ArtifactStore, c: int, seed: int = 1,
                   theta: float = 0.001, rho_scale: float = 1.0,
                   mode: int = 1, ancestral_state: bool = True, fb: int = 0,
                   first_section: int = 0,
                   last_section: Optional[int] = None, mesh=None,
                   cache: Optional[dict] = None):
    """Build per-section tree sequences (pipeline/BuildTopology.cpp).

    ``mesh``: optional device mesh. Sections (windows) are INDEPENDENT
    work units — each builds its tree sequence from its own checkpoint —
    so with a mesh they are dispatched whole-section-per-device round-
    robin over the mesh's devices (SURVEY §2.5's windows over devices;
    the reference's job arrays, Relate.cpp:95-115). Outputs are
    placement-independent (per-section seeds), so the parallel path is
    byte-identical to the serial one. Each card runs unsharded programs,
    so the merge-scan kernel never runs replicated on every card."""
    ch = store.load_chunk(c)
    model = painting.PaintingModel(N=ch.N, theta=theta)
    bounds = ch.windows.boundaries
    W = len(bounds) - 1
    if last_section is None:
        last_section = W - 1
    last_section = min(W - 1, last_section)
    ages = store.load_sample_ages(ch.N)
    rng = np.random.default_rng(seed + 1000003 * c)
    sec_seeds = rng.integers(1 << 31, size=W)
    # the fully device-resident builder covers the default path; the
    # host-driven builder handles sample ages / unknown-ancestral modes
    use_device = ancestral_state and ages is None
    kernel = None

    if mesh is not None and use_device and int(mesh.devices.size) > 1:
        return _build_topology_section_parallel(
            store, c, ch, model, bounds, W, first_section, last_section,
            sec_seeds, mesh, theta, rho_scale, mode, fb, ages, cache)
    painter = painting.Painter(ch.G, ch.r * rho_scale, model, mesh=mesh)

    # overlap the host-bound ends of each section (checkpoint npz load,
    # .anc/.mut writes) with the NEXT section's device build — the
    # replacement for the reference's section job arrays
    # (RelateParallel.sh:280-396). Device dispatches stay
    # strictly ordered (same seeds, same outputs as the serial loop).
    from concurrent.futures import ThreadPoolExecutor
    windows = list(range(first_section, last_section + 1))
    cps_mem = cache.pop(("cps", c), None) if cache is not None else None

    def _load_cp(w):
        if cps_mem is not None:
            return cps_mem[w]
        return load_checkpoint(store, c, w)

    def _persist(w, res):
        res.anc.sample_ages = ages
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                             res.anc)
        ancmut.get_age(res.anc, res.muts)
        ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                               res.muts)

    import time as _time
    t_dev = 0.0
    with ThreadPoolExecutor(max_workers=2) as pool:
        cp_futs = {w: pool.submit(_load_cp, w)
                   for w in windows[:2]}
        write_futs = []
        for i, w in enumerate(windows):
            start = bounds[w]
            end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
            end = min(end, ch.L - 1)
            cp = cp_futs.pop(w).result()
            if i + 2 < len(windows):
                nxt = windows[i + 2]
                cp_futs[nxt] = pool.submit(_load_cp, nxt)
            t0 = _time.time()
            if use_device:
                from ..core import topology_device
                if kernel is None:
                    kernel = topology_device.make_section_kernel(
                        theta, ch.N, ch.L, mode)
                res = topology_device.build_topology_section_device(
                    painter, cp, ch.G, ch.rpos, ch.state, ch.bp,
                    start, end, seed=int(sec_seeds[w]), mode=mode, fb=fb,
                    kernel=kernel)
            else:
                res = topology.build_topology_section(
                    painter, cp, ch.G, ch.rpos, ch.state, ch.bp,
                    start, end, seed=int(sec_seeds[w]), mode=mode,
                    ancestral_state=ancestral_state, fb=fb,
                    sample_ages=ages)
            t_dev += _time.time() - t0
            # free this window's device-resident checkpoint slabs NOW: the
            # handoff list pins 2 x (B, N) f32 per window on the device,
            # and holding all W of them through the build (plus the
            # GB-scale transient repaint cubes) can exhaust device memory
            # at N=2048 x 80 windows. Host copies were materialized by
            # paint()'s npz write, so dropping the device refs costs
            # nothing.
            if cps_mem is not None and cp.a0_dev is not None:
                cp.alpha, cp.beta  # noqa: B018 — force host materialization
                cp.a0_dev = None
                cp.be_dev = None
            if cache is not None:
                cache[("anc", c, w)] = res.anc
                cache[("muts", c, w)] = res.muts
            write_futs.append(pool.submit(_persist, w, res))
        for f in write_futs:
            f.result()
    if os.environ.get("RELATE_TPU_TRACE_FINE"):
        import sys as _sys
        print(f"[fine] build_topology c{c}: sections {t_dev:.2f}s "
              f"(io/persist = stage wall minus this)", file=_sys.stderr)


def _build_topology_section_parallel(store, c, ch, model, bounds, W,
                                     first_section, last_section, sec_seeds,
                                     mesh, theta, rho_scale, mode, fb, ages,
                                     cache):
    """Whole-section-per-device dispatch over the mesh's devices.

    Each device gets its own replicated panel (Painter) and processes its
    round-robin share of sections concurrently (one host thread per
    device; device work overlaps across devices, host reconstitution
    overlaps via the threads). Same per-section seeds as the serial path
    => identical artifacts."""
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from ..core import topology_device

    devs = list(mesh.devices.flatten())
    D = len(devs)
    windows = list(range(first_section, last_section + 1))
    cps_mem = cache.pop(("cps", c), None) if cache is not None else None

    painters = []
    for dev in devs:
        with jax.default_device(dev):
            painters.append(painting.Painter(ch.G, ch.r * rho_scale, model))
    kernel = topology_device.make_section_kernel(theta, ch.N, ch.L, mode)

    def _cp_for(w, dev):
        cp = cps_mem[w] if cps_mem is not None \
            else load_checkpoint(store, c, w)
        if cp.a0_dev is not None and cp.a0_dev.devices() != {dev}:
            # mesh-painted slabs are sharded with rows padded to the
            # device count; this card's painter wants its own (N, N)
            n = cp._n
            cp = painting.Checkpoint(
                alpha=cp._alpha, beta=cp._beta, ls_alpha=cp.ls_alpha,
                ls_beta=cp.ls_beta, bsb=cp.bsb, bse=cp.bse,
                a0_dev=jax.device_put(cp.a0_dev[:n], dev),
                be_dev=jax.device_put(cp.be_dev[:n], dev), n=n)
        return cp

    def _run_dev(k):
        dev = devs[k]
        out = []
        with jax.default_device(dev):
            for w in windows[k::D]:
                start = bounds[w]
                end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
                end = min(end, ch.L - 1)
                res = topology_device.build_topology_section_device(
                    painters[k], _cp_for(w, dev), ch.G, ch.rpos, ch.state,
                    ch.bp, start, end, seed=int(sec_seeds[w]), mode=mode,
                    fb=fb, kernel=kernel)
                # drop the consumed window's device slabs (see the serial
                # loop: pinning all W of them through the stage can run
                # the device out of memory)
                if cps_mem is not None and cps_mem[w].a0_dev is not None:
                    cps_mem[w].alpha, cps_mem[w].beta  # noqa: B018
                    cps_mem[w].a0_dev = None
                    cps_mem[w].be_dev = None
                out.append((w, res))
        return out

    with ThreadPoolExecutor(max_workers=D) as pool:
        parts = list(pool.map(_run_dev, range(D)))
    results = dict(p for part in parts for p in part)

    for w in windows:
        res = results[w]
        res.anc.sample_ages = ages
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                             res.anc)
        ancmut.get_age(res.anc, res.muts)
        ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                               res.muts)
        if cache is not None:
            cache[("anc", c, w)] = res.anc
            cache[("muts", c, w)] = res.muts


def _associate_many(all_trees):
    """Pick the FEB matcher: the fully device-resident batch matcher
    (core/branch_association_device.py) on accelerator backends with
    enough pairs to amortize its compile, else the host matcher. Both
    produce identical equivalences (differential-tested)."""
    import jax as _jax
    use_dev = os.environ.get("RELATE_TPU_FEB_DEVICE")
    if use_dev is None:
        use_dev = (_jax.default_backend() != "cpu"
                   and len(all_trees) >= 65)
    else:
        use_dev = use_dev != "0"
    if use_dev:
        from ..core.branch_association_device import (
            branch_association_many_device)
        return branch_association_many_device(all_trees)
    return branch_association_many(all_trees)


def find_equivalent_branches(store: ArtifactStore, c: int,
                             cache: Optional[dict] = None):
    """Associate branches across all adjacent trees of a chunk (incl. window
    boundaries) and propagate events/spans
    (pipeline/FindEquivalentBranches.cpp).

    ``cache``: run_all's in-memory stage handoff — stages still WRITE every
    artifact (the resume model is unchanged) but skip re-READING what the
    previous stage just produced."""
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    stream_thr = int(os.environ.get("RELATE_TPU_FEB_STREAM_WINDOWS", "16"))
    if W >= stream_thr:
        return _find_equivalent_branches_streamed(store, c, W)

    def _get(w):
        if cache is not None and ("anc", c, w) in cache:
            return cache[("anc", c, w)]
        return ancmut.read_anc_bin(store.path(f"chunk_{c}",
                                              f"trees_{w}.anc"))
    ancs = [_get(w) for w in range(W)]
    all_trees = [mt.tree for anc in ancs for mt in anc.seq]
    eqs = _associate_many(all_trees)
    associate_trees(all_trees, eqs)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(ancmut.write_anc_bin,
                            store.path(f"chunk_{c}", f"trees_{w}.anc"),
                            ancs[w]) for w in range(W)]
        for f in futs:
            f.result()
    if cache is not None:
        for w in range(W):
            cache[("anc", c, w)] = ancs[w]


def _find_equivalent_branches_streamed(store: ArtifactStore, c: int,
                                       W: int):
    """Streaming FEB for long chunks (VERDICT r3 weak #8): the in-memory
    path materializes EVERY window's trees at once — a multi-GB host spike
    at 1000G chunk sizes. Here at most two windows are resident:

    - forward pass (window order): match each window's adjacent pairs —
      including the boundary pair with the previous window's last tree —
      and run the forward association sweep continuing through the carried
      boundary tree; write the window back (its trees now hold
      forward-accumulated events/SNP_begin) and keep only the per-window
      equivalence vectors (a few MB).
    - backward pass (reverse order): re-read each window, run the backward
      sweep continuing through the carried boundary tree, write it back.

    Byte-identical to the in-memory path (the sweeps factor exactly across
    consecutive runs; tested in tests/test_cli_smoke.py)."""
    from ..core.branch_association import (associate_backward,
                                           associate_forward)
    eqs_by_window: List[List[np.ndarray]] = []
    prev_last = None       # last tree of the previous window
    for w in range(W):
        anc = ancmut.read_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"))
        trees = [mt.tree for mt in anc.seq]
        run = ([prev_last] if prev_last is not None else []) + trees
        eqs = _associate_many(run) if len(run) > 1 else []
        associate_forward(run, eqs)
        eqs_by_window.append(eqs)
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                             anc)
        prev_last = trees[-1]
    next_first = None      # first tree of the following window
    next_eq = None         # equivalence of the boundary pair
    for w in range(W - 1, -1, -1):
        anc = ancmut.read_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"))
        trees = [mt.tree for mt in anc.seq]
        eqs = eqs_by_window[w]
        if next_first is not None:
            run = trees + [next_first]
            associate_backward(run, eqs[1:] + [next_eq]
                               if w > 0 else eqs + [next_eq])
        else:
            run = trees
            associate_backward(run, eqs[1:] if w > 0 else eqs)
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                             anc)
        next_first = trees[0]
        next_eq = eqs[0] if w > 0 else None


def infer_branch_lengths(store: ArtifactStore, c: int, Ne: float = 3e4,
                         mu: float = 1.25e-8, seed: int = 1,
                         epochs: Optional[np.ndarray] = None,
                         rates: Optional[np.ndarray] = None,
                         first_section: int = 0,
                         last_section: Optional[int] = None, mesh=None,
                         cache: Optional[dict] = None):
    """Branch-length MCMC per section (pipeline/InferBranchLengths.cpp);
    the per-section tree batch is one vmapped chain batch.

    With a coalescence-rate prior, epochs (generations) and rates
    (per-generation) are normalized by the implied average Ne = 1/mean(rate)
    into coalescent units (InferBranchLengths.cpp:86-152)."""
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    if last_section is None:
        last_section = W - 1
    if epochs is not None:
        rts = np.asarray(rates, dtype=np.float64)
        pos = rts[np.isfinite(rts) & (rts > 0)]
        avg_ne = 1.0 / pos.mean()
        Ne = avg_ne
        rates = rts * avg_ne
        epochs = np.asarray(epochs, dtype=np.float64) / avg_ne
    ages = store.load_sample_ages(ch.N)
    # overlap the per-section .anc reads/writes with the (device-bound)
    # chain batches of neighboring sections (VERDICT r3 #9)
    from concurrent.futures import ThreadPoolExecutor
    windows = list(range(first_section, last_section + 1))
    dist64 = ch.dist.astype(np.float64)

    def _read(w):
        if cache is not None and ("anc", c, w) in cache:
            return cache[("anc", c, w)]
        return ancmut.read_anc_bin(store.path(f"chunk_{c}",
                                              f"trees_{w}.anc"))

    import time as _time
    t_mcmc = 0.0
    with ThreadPoolExecutor(max_workers=2) as pool:
        read_futs = {w: pool.submit(_read, w) for w in windows[:2]}
        write_futs = []
        for i, w in enumerate(windows):
            anc = read_futs.pop(w).result()
            if i + 2 < len(windows):
                nxt = windows[i + 2]
                read_futs[nxt] = pool.submit(_read, nxt)
            trees = [mt.tree for mt in anc.seq]
            t0 = _time.time()
            bl = mcmc.run_mcmc(trees, dist64, ch.L,
                               Ne=Ne, mu=mu,
                               seed=seed + 7919 * (c + 1) + w,
                               epochs=epochs, rates=rates,
                               sample_ages=ages, mesh=mesh)
            t_mcmc += _time.time() - t0
            for k, mt in enumerate(anc.seq):
                mt.tree.branch_length = bl[k]
            if cache is not None:
                cache[("anc", c, w)] = anc
            write_futs.append(pool.submit(
                ancmut.write_anc_bin,
                store.path(f"chunk_{c}", f"trees_{w}.anc"), anc))
        for f in write_futs:
            f.result()
    if os.environ.get("RELATE_TPU_TRACE_FINE"):
        import sys as _sys
        print(f"[fine] infer c{c}: run_mcmc {t_mcmc:.2f}s",
              file=_sys.stderr)


def combine_sections(store: ArtifactStore, c: int,
                     cache: Optional[dict] = None):
    """Splice per-section tree sequences + fill mutation ages
    (pipeline/CombineSections.cpp)."""
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    seq: List[MarginalTree] = []
    muts = []
    ages = None
    for w in range(W):
        if cache is not None and ("anc", c, w) in cache:
            anc = cache[("anc", c, w)]
        else:
            anc = ancmut.read_anc_bin(store.path(f"chunk_{c}",
                                                 f"trees_{w}.anc"))
        ages = anc.sample_ages
        if cache is not None and ("muts", c, w) in cache:
            mshort = cache[("muts", c, w)]
        else:
            mshort = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                      f"muts_{w}.mut"))
        off = len(seq)
        for m in mshort:
            m.tree += off
        seq.extend(anc.seq)
        muts.extend(mshort)
    anc = AncesTree(N=ch.N, seq=seq, sample_ages=ages)
    ancmut.get_age(anc, muts)
    if cache is not None:
        cache[("combined", c)] = (anc, muts)
    ancmut.write_anc_bin(store.path(f"chunk_{c}", "combined.anc"), anc)
    ancmut.write_mut_short(store.path(f"chunk_{c}", "combined.mut"), muts)
    # completion sentinel for the multi-host barrier: written last, after
    # BOTH combined artifacts are atomically in place
    with ancmut.atomic_write(store.path(f"chunk_{c}", "DONE")) as f:
        f.write("ok\n")


def post_process_chunk(store: ArtifactStore, c: int, seed: int = 1,
                       randomise: bool = False):
    """Topology post-processing of a chunk's sections (pipeline/
    PostProcess.cpp:311,980): NNI-refine unsupported branches against the
    local carrier sets, then let the caller re-run
    find_equivalent_branches (Relate.cpp:276-279 re-associates after
    PostProcess inside --mode All)."""
    from .postprocess import post_process
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    total = 0
    for w in range(W):
        anc = ancmut.read_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"))
        muts = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                f"muts_{w}.mut"))
        total += post_process(anc, muts, ch.G, ch.bp, seed=seed + w,
                              randomise=randomise)
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"), anc)
        ancmut.get_age(anc, muts)
        ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                               muts)
    return total


def _read_annot(path: str):
    """Read a .annot file: header line + one row per SNP
    (Finalize.cpp:61-84 joins these onto the final .mut)."""
    from ..io.haps import smart_open
    with smart_open(path) as f:
        header = f.readline().rstrip("\n")
        rows = [line.rstrip("\n") for line in f]
    return header, rows


def finalize(store: ArtifactStore, output: str, cleanup: bool = False,
             annot_path: Optional[str] = None,
             cache: Optional[dict] = None):
    """Merge chunks dropping half-overlaps, write final text .anc/.mut
    (pipeline/Finalize.cpp:107-290). With ``annot_path``, each kept SNP's
    annotation row is appended to its .mut line and the annot header to the
    .mut header (Finalize.cpp:98-183)."""
    plan, _ = store.load_plan()
    props = np.load(store.path("props.npz"), allow_pickle=False)
    rsid = props["rsid"]
    anc_al = props["ancestral"]
    alt_al = props["alternative"]
    bp = props["bp"]
    dist = props["dist"]

    annot_header = None
    annot_rows = None
    if annot_path:
        annot_header, annot_rows = _read_annot(annot_path)

    mut_rows: List[str] = []
    out_trees: List[MarginalTree] = []
    num_trees_cum = 0
    num_flips = 0
    num_non_mapping = 0
    sample_ages = None

    for c in range(plan.num_chunks):
        start_chunk = plan.start[c]
        end_chunk = plan.end[c]
        if cache is not None and ("combined", c) in cache:
            anc, muts = cache[("combined", c)]
        else:
            anc = ancmut.read_anc_bin(store.path(f"chunk_{c}",
                                                 "combined.anc"))
            muts = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                    "combined.mut"))
        sample_ages = anc.sample_ages
        ov = MERGE_DISCARD if c > 0 else 0
        if plan.num_chunks > 1 and c + 1 != plan.num_chunks:
            keep_end = end_chunk - MERGE_DISCARD
        else:
            keep_end = end_chunk

        # ---- mutations -----------------------------------------------
        first_tree = None
        for local in range(ov, keep_end - start_chunk):
            snp = start_chunk + local
            m = muts[local]
            if first_tree is None:
                first_tree = m.tree
            if m.is_not_mapping:
                num_non_mapping += 1
            if m.flipped:
                num_flips += 1
            tree_out = m.tree - first_tree + num_trees_cum
            br = " ".join(str(b) for b in m.branch)
            row = (
                f"{snp};{bp[snp]};{dist[snp]};{rsid[snp]};{tree_out};{br};"
                f"{1 if m.is_not_mapping else 0};{int(m.flipped)};"
                f"{ancmut._fmt_g(m.age_begin)};{ancmut._fmt_g(m.age_end)};"
                f"{anc_al[snp]}/{alt_al[snp]};")
            if annot_rows is not None and snp < len(annot_rows):
                row += annot_rows[snp]
            mut_rows.append(row)

        # ---- trees ---------------------------------------------------
        seq = list(anc.seq)
        if c > 0:
            # drop leading trees fully inside the discarded overlap
            while len(seq) > 1 and seq[1].pos <= MERGE_DISCARD:
                seq.pop(0)
            seq[0] = MarginalTree(pos=MERGE_DISCARD + start_chunk,
                                  tree=seq[0].tree)
        else:
            seq[0] = MarginalTree(pos=start_chunk + seq[0].pos,
                                  tree=seq[0].tree)
        kept = [seq[0]]
        for mt in seq[1:]:
            pos = mt.pos + start_chunk
            if pos < keep_end:
                kept.append(MarginalTree(pos=pos, tree=mt.tree))
        for mt in kept:
            mt.tree.SNP_begin[:] = mt.tree.SNP_begin + start_chunk
            mt.tree.SNP_end[:] = mt.tree.SNP_end + start_chunk
        out_trees.extend(kept)
        num_trees_cum += len(kept)

    final = AncesTree(N=plan.N, seq=out_trees, sample_ages=sample_ages)
    ancmut.write_anc_text(output + ".anc", final)
    ancmut.write_mut_final(output + ".mut", mut_rows,
                           extra_header=annot_header or "")
    if cleanup:
        shutil.rmtree(store.outdir, ignore_errors=True)
    return num_non_mapping, num_flips


def run_all(haps_path: str, sample_path: str, map_path: str, output: str,
            Ne: float = 3e4, mu: float = 1.25e-8, seed: int = 1,
            memory_gb=None, theta: float = 0.001,
            dist_path: Optional[str] = None, use_transitions: bool = True,
            sample_ages_path: Optional[str] = None,
            coal: Optional[tuple] = None, cleanup: bool = True,
            verbose: bool = True, rho_scale: float = 1.0,
            postprocess: bool = False, annot_path: Optional[str] = None,
            mesh=None, threads: int = 1):
    """Relate --mode All (pipeline/Relate.cpp:257-287).

    ``rho_scale`` applies the reference's ``--painting theta,rho`` override
    (Paint.cpp:38-61) to both Paint and BuildTopology; ``postprocess``
    inserts the optional PostProcess + re-association stage
    (Relate.cpp:276-279); ``annot_path`` joins annotations into the final
    .mut (Finalize.cpp:98-183).

    Distribution (replacing the reference's SGE/Slurm/LSF job arrays,
    SURVEY §2.5): with ``mesh``, painting targets and MCMC tree batches are
    sharded over the mesh devices; under multi-process JAX, chunks
    are round-robined over processes (each paints/builds its chunks
    against its own replica of the panel) and host 0 performs the
    Finalize merge once all chunk artifacts exist in the shared store."""
    import jax as _jax
    store = ArtifactStore(output + ".tmpdir")
    # host identity: jax.distributed when initialized, else overridable via
    # env for filesystem-coordinated launches (the reference's cluster
    # model — one process per host, shared store, no RPC):
    #   RELATE_TPU_NUM_HOSTS=4 RELATE_TPU_HOST_ID=k python -m
    #     relate_tpu.pipeline.cli All ... (same output path on all hosts)
    n_hosts0 = int(os.environ.get("RELATE_TPU_NUM_HOSTS",
                                  _jax.process_count()))
    host_id = int(os.environ.get("RELATE_TPU_HOST_ID",
                                 _jax.process_index()))
    barrier_timeout = float(os.environ.get("RELATE_TPU_BARRIER_TIMEOUT_S",
                                           "86400"))
    if n_hosts0 > 1 and host_id != 0:
        # host 0 plans the chunks; other hosts wait for the shared plan
        # (plan.json is written atomically and LAST, so its existence
        # implies all chunk inputs are on disk)
        import time
        t0 = time.time()
        while not os.path.exists(store.path("plan.json")):
            if time.time() - t0 > barrier_timeout:
                raise TimeoutError(
                    f"host {host_id}: plan.json did not appear "
                    f"within {barrier_timeout}s — did host 0 fail?")
            time.sleep(0.2)
        plan, _ = store.load_plan()
    else:
        plan = make_chunks(haps_path, sample_path, map_path, store.outdir,
                           memory_gb, dist_path, use_transitions,
                           sample_ages_path)
    if verbose:
        print(f"[relate] N={plan.N} L={plan.L} chunks={plan.num_chunks}")
    epochs = rates = None
    if coal is not None:
        epochs, rates = coal
    from ..utils.trace import stage, summary
    n_hosts = n_hosts0
    host = host_id

    # run-level handoff for Finalize's combined-artifact reads — bounded:
    # only kept for small chunk counts (each entry holds a whole chunk's
    # trees in memory; at many-chunk genome scale finalize re-reads)
    fin_cache: Optional[dict] = {} if plan.num_chunks <= 2 else None
    _, wplans_all = store.load_plan()

    def _process_chunk(c: int):
        # in-memory stage handoff: every artifact is still written (the
        # resume model is unchanged) but the next stage skips re-reading
        # what the previous stage just produced in this process. Long
        # chunks (many windows) skip the handoff so peak memory stays
        # bounded at ~2 windows (FEB then streams; VERDICT r3 weak #8).
        W_c = wplans_all[c].num_windows
        stream_thr = int(os.environ.get("RELATE_TPU_FEB_STREAM_WINDOWS",
                                        "16"))
        if W_c >= stream_thr:
            cache = None
        else:
            cache = {} if fin_cache is None else fin_cache
        # the paint->build checkpoint handoff has its own (bounded) cache:
        # re-reading + re-uploading a 2x(N,N) checkpoint npz per section
        # costs seconds each at N>=2048, and the FEB streaming threshold
        # shouldn't disable it. Bounded by total slab bytes.
        paint_cache = cache
        if cache is None:
            W_bytes = 2 * 4 * plan.N * plan.N * W_c
            if W_bytes <= float(os.environ.get(
                    "RELATE_TPU_CP_HANDOFF_BYTES", "4e9")):
                paint_cache = {}
        with stage(f"chunk{c}.paint", verbose):
            paint(store, c, theta, rho_scale=rho_scale, mesh=mesh,
                  cache=paint_cache)
        with stage(f"chunk{c}.build_topology", verbose):
            build_topology(store, c, seed=seed, theta=theta,
                           rho_scale=rho_scale, mesh=mesh,
                           cache=paint_cache)
        if paint_cache is not None and cache is None:
            paint_cache.clear()
        with stage(f"chunk{c}.find_equivalent_branches", verbose):
            find_equivalent_branches(store, c, cache=cache)
        if postprocess:
            with stage(f"chunk{c}.post_process", verbose):
                # post_process_chunk works on the on-disk artifacts;
                # invalidate the handoff so the re-association below
                # re-reads its output. The cache is None for streamed
                # (many-window) chunks, and may be shared across chunks —
                # evict only this chunk's keys.
                if cache is not None:
                    for k in [k for k in cache if k[1] == c]:
                        del cache[k]
                post_process_chunk(store, c, seed=seed)
                find_equivalent_branches(store, c, cache=cache)
        with stage(f"chunk{c}.infer_branch_lengths", verbose):
            infer_branch_lengths(store, c, Ne=Ne, mu=mu, seed=seed,
                                 epochs=epochs, rates=rates, mesh=mesh,
                                 cache=cache)
        with stage(f"chunk{c}.combine_sections", verbose):
            combine_sections(store, c, cache=cache)

    # chunks owned by this host (others are filesystem-shared, as in the
    # reference's job arrays)
    my_chunks = [c for c in range(plan.num_chunks) if c % n_hosts == host]
    if threads > 1 and len(my_chunks) > 1:
        # RelateParallel.sh's bash-job thread pool (SURVEY §2.5): chunks
        # are independent; device dispatches serialize on the chip while
        # each chunk's host-bound stages (IO, branch matching, text
        # formats) overlap with other chunks' device work. Output is
        # byte-identical to the sequential order (per-chunk seeds).
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for _ in ex.map(_process_chunk, my_chunks):
                pass
    else:
        for c in my_chunks:
            _process_chunk(c)
    if n_hosts > 1:
        # barrier: wait for every chunk's DONE sentinel (written atomically
        # AFTER both combined artifacts — a poller can never read a
        # half-written combined.anc/.mut), with a timeout so a dead host
        # fails the run instead of hanging it
        import time
        t0 = time.time()
        done = False
        for c in range(plan.num_chunks):
            while not os.path.exists(store.path(f"chunk_{c}", "DONE")):
                # host 0 may have finalized (and cleaned the store) before
                # this host observed the sentinels: the final output is the
                # terminal sentinel
                if os.path.exists(output + ".anc"):
                    done = True
                    break
                if time.time() - t0 > barrier_timeout:
                    raise TimeoutError(
                        f"host {host}: chunk {c} DONE sentinel did not "
                        f"appear within {barrier_timeout}s")
                time.sleep(0.2)
            if done:
                break
        if host != 0:
            return output
    with stage("finalize", verbose):
        nnm, nfl = finalize(store, output, cleanup=cleanup,
                            annot_path=annot_path, cache=fin_cache)
    if verbose:
        print(f"[relate] Number of not mapping SNPs: {nnm}")
        print(f"[relate] Number of flipped SNPs    : {nfl}")
        summary()
    return output


def read_opt_grid(path: str):
    """Parse an OptimizeParameters --input grid file: line 1 = theta values
    in (0,1), line 2 = recombination factors
    (OptimizeParameters.cpp:81-113)."""
    with open(path) as f:
        thetas = [float(x) for x in f.readline().split()]
        rhos = [float(x) for x in f.readline().split()]
    for t in thetas:
        if not 0.0 < t < 1.0:
            raise ValueError("theta value has to be in (0,1)")
    return thetas, rhos


def write_opt(path: str, results):
    """Write the .opt grid-search output: one 'theta rho num_notmapping'
    line per combination (OptimizeParameters.cpp:183-189)."""
    with open(path, "w") as f:
        for theta, rho, score in results:
            f.write(f"{theta:g} {rho:g} {score:g}\n")


def optimize_parameters(store: ArtifactStore, c: int,
                        thetas=None, rho_scales=None,
                        section: int = 0, max_snps: int = 2000,
                        seed: int = 1):
    """Grid-search painting parameters (pipeline/OptimizeParameters.cpp:
    theta in {1e-4..1e-1}, rho-scale in {0.001..100}, :76-77): for each
    combination, repaint a section and count SNPs that do not map onto a
    tree built from the distance matrix with the SNP's own signal cancelled
    (anc_builder.cpp:821-979). Returns list of (theta, rho, frac_nonmapping).
    """
    from ..core import mapmutation
    from ..core.distance import DistanceAssembler
    from ..core.treebuilder import quick_build

    if thetas is None:
        thetas = [1e-4, 1e-3, 1e-2, 1e-1]
    if rho_scales is None:
        rho_scales = [0.001, 0.1, 1.0, 10.0, 100.0]
    ch = store.load_chunk(c)
    bounds = ch.windows.boundaries
    start = bounds[section]
    end = min(bounds[section + 1] - 1, ch.L - 1, start + max_snps)
    results = []
    log_ratio_cache = {}
    for theta in thetas:
        for rho in rho_scales:
            model = painting.PaintingModel(N=ch.N, theta=theta)
            painter = painting.Painter(ch.G, ch.r * rho, model)
            cps = painter.paint_stepping_stones(np.asarray(bounds))
            paint = painter.repaint(cps[section])
            assembler = DistanceAssembler(ch.G, ch.rpos)
            dstate = assembler.init_state(paint.plan, start)
            log_ratio = float(np.log(theta / (1.0 - theta)))
            nonmap = 0
            total = 0
            for snp in range(start, end + 1):
                carriers = np.nonzero(ch.G[snp])[0]
                if snp > start:
                    dstate = assembler.advance(dstate, snp, carriers)
                if len(carriers) == 0 or len(carriers) == ch.N:
                    continue
                mat = np.array(assembler.get_matrix(
                    paint, dstate, snp,
                    is_first_or_last=(snp in (0, ch.L - 1))))
                # cancel the current SNP's own signal
                # (anc_builder.cpp:869-881)
                mask = ch.G[snp] == 1
                mat[np.ix_(mask, ~mask)] += log_ratio
                mat[mask] -= mat[mask].min(axis=1, keepdims=True)
                tree = quick_build(mat, theta=theta, seed=seed)
                res = mapmutation.map_mutations_block(
                    tree, tree.leaf_matrix(),
                    ch.G[snp: snp + 1].astype(np.uint8))
                total += 1
                if res.is_mapping[0] > 1:
                    nonmap += 1
            results.append((theta, rho, nonmap / max(total, 1)))
    return results
