"""Smoke test of relate-tpu on an NVIDIA GPU: the quickest proof that the
system still starts, compiles its kernels and runs its main path on a card.

Usage::

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --devices 4  # four cards: phase 5 only

Phases (any failure exits non-zero, and then no result line is printed):

1. device: JAX must find a GPU; there is no CPU fallback. Prints the
   card's name and power limit (nvidia-smi) and ``jax.__version__``.
2. kernels: every Pallas kernel of the main path, compiled for the card,
   against its plain reference at real widths (N=2048 and N=5008). The
   painting kernels must match the ``lax.scan`` twins (rtol 1e-5), both
   called directly and through the ``Painter`` as ``run_all`` drives them
   (stepping stones and a repaint of every window of the phase-4 panel,
   which must plan into >= 2 windows); the incremental merge scan must be
   bit-exact to its NumPy spec ``merge_scan_inc_host``, with and without
   the CF prior. Prints each direct call's ``compiled.memory_analysis()``.
3. golden gate: BuildTopology on the in-repo golden chunk
   (``tests/golden/chunk_0.*``) through the merge kernel ``run_all`` takes
   on the card, scored against the reference binary's ``postbt_0``:
   tree ratio in [0.92, 1.08], clade agreement >= 0.78.
4. main path: ``python -m relate_tpu.pipeline.cli --mode All`` on a
   seeded N=5008 panel. The .anc/.mut must parse, hold at least one tree
   and one record per SNP. Stage walls and peak device memory are printed
   for information.
5. four cards (``--devices 4``): the phase-4 panel through
   ``--mode All --devices 4`` and through one card must give
   byte-identical .anc/.mut; each card's peak memory is printed.

Phases 1-3 run in one child process and the phase-4 CLI in its own, one
after the other. Phase 5 runs the four-card CLI in a child that holds the
four cards and, beside it, the one-card CLI on the last card; each process
gets a share of the card's memory and both get the same window-planner
budget. This parent never starts a JAX backend. The last line of standard
output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_N = 5008          # 1000 Genomes: 2504 diploid samples
SMOKE_L = 400           # 2 windows at the planner's H100 budget
SMOKE_SEED = 11
DEVICE_TAG = "SMOKE_DEVICE "
# phase 5: the share of a card's memory each of its two processes takes,
# and the planner budget both are given (what the planner picks by itself
# on an 80 GB card at JAX's default share, near enough)
PHASE5_MEM_FRACTION = "0.45"
PHASE5_MEMORY_GB = 3.0


def _say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# child: phases 1-3 (the only code here that starts a JAX backend)
# ---------------------------------------------------------------------------

def _device_phase() -> dict:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"phase 1: no GPU found (JAX platform "
                         f"{devs[0].platform!r})")
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    _say(f"phase 1 device: {dev} jax {jax.__version__}")
    return dev


def _memory(fn, *args):
    """Compile ``fn`` for these arguments; print its memory analysis."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    _say(f"    memory_analysis: {compiled.memory_analysis()}")
    return compiled


def _merge_inputs(N: int):
    import numpy as np
    rng = np.random.default_rng(N)
    X = rng.random((N, N), dtype=np.float32) * 100
    d = ((X + X.T) / 2 + rng.random((N, N), dtype=np.float32))
    np.fill_diagonal(d, 0)
    dcf = (rng.random((N, N)) < 0.5).astype(np.float32) * 6.9
    return d.astype(np.float32), dcf


def _merge_kernel_check(N: int) -> None:
    import jax.numpy as jnp
    import numpy as np

    from relate_tpu.core.treebuilder import thresholds
    from relate_tpu.ops.merge_scan_inc import (merge_scan_inc_host,
                                               merge_scan_incremental)
    thr, thrcf = thresholds(0.001)
    d, dcf = _merge_inputs(N)
    for use_cf in (False, True):
        _say(f"  merge scan N={N} cf={use_cf}")
        seed = jnp.int32(5)
        run = _memory(lambda a, b, s: merge_scan_incremental(
            a, b, use_cf, thr, thrcf, s), jnp.asarray(d), jnp.asarray(dcf),
            seed)
        t0 = time.perf_counter()
        cis, cjs, clades = run(jnp.asarray(d), jnp.asarray(dcf), seed)
        clades.block_until_ready()
        t_k = time.perf_counter() - t0
        cis_h, cjs_h = merge_scan_inc_host(d, dcf, use_cf, thr, thrcf, 5)
        if not (np.array_equal(np.asarray(cis), cis_h)
                and np.array_equal(np.asarray(cjs), cjs_h)):
            raise SystemExit(f"phase 2: merge scan N={N} cf={use_cf} is "
                             "not bit-exact to merge_scan_inc_host")
        if np.asarray(clades)[-1].sum() != N:
            raise SystemExit("phase 2: merge scan root clade is not N")
        _say(f"    bit-exact to merge_scan_inc_host ({t_k:.3f}s on card)")


def _paint_kernel_check(N: int, L: int) -> None:
    import jax.numpy as jnp
    import numpy as np

    from relate_tpu.core import painting
    from relate_tpu.ops import paint_kernels as pk
    from relate_tpu.utils.synth import synth_panel

    G, _ = synth_panel(N, L, seed=3)
    r = np.full(L, 2e-4)
    model = painting.PaintingModel(N=N, theta=0.001)
    tg = np.arange(N, dtype=np.int32)
    plan = painting.build_target_plan(G, r, model, 0, L - 1, tg)
    _say(f"  painting N={N} window of {L} SNPs, Dmax={plan.Dmax}")
    alpha0 = painting.initial_alpha(G, model, 0, tg)
    beta_end = np.ones((N, N), np.float32)
    ref = painting.Painter(G, r, model, use_kernel=False)
    dev = ref._plan_dev(plan)
    a_all, lsf = ref._run_fwd(plan, alpha0, dev)
    topo_s, lst_s, beta_s, lsb_s = ref._run_bwd(plan, a_all, lsf, beta_end,
                                                dev)
    valid = np.arange(plan.Dmax)[:, None] < plan.D[None, :]
    args = tuple(jnp.asarray(x) for x in (G, plan.idx, plan.seqk, plan.pfac,
                                          plan.nxt, plan.D, tg))
    want = jnp.asarray(plan.D // 2, jnp.int32)
    bidx = np.arange(N)

    def close(name, got, exp, atol):
        if not np.allclose(got, exp, rtol=1e-5, atol=atol):
            err = np.abs(got - exp).max()
            raise SystemExit(f"phase 2: painting {name} N={N} differs "
                             f"from the scan twin (max abs err {err:.3e})")

    post = _memory(lambda *a: pk.paint_posterior(*a, theta=model.theta),
                   *args, jnp.asarray(alpha0), jnp.asarray(beta_end))
    topo_k, lst_k = post(*args, jnp.asarray(alpha0), jnp.asarray(beta_end))
    close("posterior", np.asarray(topo_k)[valid], np.asarray(topo_s)[valid],
          1e-30)
    close("logscale", np.asarray(lst_k)[valid], np.asarray(lst_s)[valid],
          1e-4)
    del topo_k, topo_s
    fcap = _memory(lambda *a: pk.paint_fwd_capture(*a, theta=model.theta),
                   *args, want, jnp.asarray(alpha0))
    acap, _ = fcap(*args, want, jnp.asarray(alpha0))
    w = np.asarray(want)
    close("forward capture", np.asarray(acap), np.asarray(a_all)[w, bidx],
          1e-30)
    bcap = _memory(lambda *a: pk.paint_bwd_capture(*a, theta=model.theta),
                   *args, want, jnp.asarray(beta_end))
    bc, lbc = bcap(*args, want, jnp.asarray(beta_end))
    close("backward capture", np.asarray(bc), np.asarray(beta_s)[w, bidx],
          1e-30)
    close("backward capture logscale", np.asarray(lbc),
          np.asarray(lsb_s)[w, bidx], 1e-4)
    _say("    posterior and captures match the scan twins (rtol 1e-5)")


def _painter_check() -> None:
    """The painting path ``run_all`` takes on the card (device planner,
    span slicing, device-resident checkpoint slabs) against the scan twins
    with host plans: stepping stones, then a repaint of every window, on
    the phase-4 panel."""
    import numpy as np

    from relate_tpu.core import painting
    from relate_tpu.io import chunking
    from relate_tpu.utils.synth import synth_panel

    G, _ = synth_panel(SMOKE_N, SMOKE_L, seed=SMOKE_SEED)
    _, wplans = chunking.plan_chunks_and_windows(G, None)
    bounds = np.asarray(wplans[0].boundaries)
    _say(f"  Painter N={SMOKE_N} L={SMOKE_L} windows {bounds.tolist()}")
    if len(bounds) < 3:
        raise SystemExit("phase 2: the Painter panel plans into one window")
    r = np.full(SMOKE_L, 2e-4)
    model = painting.PaintingModel(N=SMOKE_N, theta=0.001)
    p_s = painting.Painter(G, r, model, use_kernel=False)
    p_k = painting.Painter(G, r, model)
    if not p_k.use_kernel:
        raise SystemExit("phase 2: the Painter does not choose its kernels")

    def close(name, got, exp):
        if not np.allclose(got, exp, rtol=1e-5, atol=1e-30):
            err = np.abs(got - exp).max()
            raise SystemExit(f"phase 2: Painter {name} differs from the "
                             f"scan twin (max abs err {err:.3e})")

    t0 = time.perf_counter()
    cps_s = p_s.paint_stepping_stones(bounds)
    t_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cps_k = p_k.paint_stepping_stones(bounds)
    t_k = time.perf_counter() - t0
    for w, (cs, ck) in enumerate(zip(cps_s, cps_k)):
        close(f"stepping stone {w} alpha", ck.alpha, cs.alpha)
        close(f"stepping stone {w} beta", ck.beta, cs.beta)
    _say(f"    stepping stones match ({t_k:.1f}s kernels, {t_s:.1f}s scan, "
         "cold)")
    for w in range(len(cps_k)):
        out_s = p_s.repaint(cps_s[w])
        topo_s = np.asarray(out_s.topology)
        topo_k = np.asarray(p_k.repaint(cps_k[w]).topology)
        D = np.asarray(out_s.plan.D)
        for k in range(int(D.max())):
            live = D > k
            close(f"window {w} repaint step {k}", topo_k[k][live],
                  topo_s[k][live])
        del topo_s, topo_k, out_s
    _say("    repaint of every window matches the scan twins (rtol 1e-5)")


def _clade_sets(anc, muts, hi):
    import numpy as np
    out, leafmats = {}, {}
    for snp in range(hi):
        m = muts[snp]
        if len(m.branch) != 1:
            continue
        if m.tree not in leafmats:
            leafmats[m.tree] = anc.seq[m.tree].tree.leaf_matrix() > 0
        out[snp] = frozenset(
            np.nonzero(leafmats[m.tree][int(m.branch[0])])[0])
    return out


def _golden_phase() -> None:
    import numpy as np

    from relate_tpu.core import painting, topology_device
    from relate_tpu.io import ancmut, chunking

    gdir = os.path.join(ROOT, "tests", "golden")
    tmp = tempfile.mkdtemp(prefix="smoke_golden_")
    try:
        for fn in os.listdir(gdir):
            if fn.startswith(("chunk_0.", "postbt_0.")):
                with gzip.open(os.path.join(gdir, fn), "rb") as fi, \
                        open(os.path.join(tmp, fn[:-3]), "wb") as fo:
                    shutil.copyfileobj(fi, fo)
        ch = chunking.read_reference_chunk(os.path.join(tmp, "chunk_0"))
        ref_anc = ancmut.read_anc_bin(os.path.join(tmp, "postbt_0.anc"))
        ref_muts = ancmut.read_mut_short(os.path.join(tmp, "postbt_0.mut"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L, N = ch.G.shape
    painter = painting.Painter(ch.G, ch.r, painting.PaintingModel(N=N))
    cps = painter.paint_stepping_stones(np.asarray([0, L]))
    if not topology_device.use_merge_kernel():
        raise SystemExit("phase 3: BuildTopology does not choose the merge "
                         "kernel")
    SUB, MARGIN = 12000, 500
    hi = SUB - MARGIN
    ref = _clade_sets(ref_anc, ref_muts, hi)
    ref_trees = sum(1 for mt in ref_anc.seq if mt.pos < hi)
    kernel = topology_device.make_section_kernel(0.001, N, L, 1)
    t0 = time.perf_counter()
    res = topology_device.build_topology_section_device(
        painter, cps[0], ch.G, ch.rpos, ch.state, ch.bp, 0, SUB,
        seed=1, kernel=kernel)
    wall = time.perf_counter() - t0
    ours = _clade_sets(res.anc, res.muts, hi)
    common = set(ours) & set(ref)
    agree = sum(1 for s in common if ours[s] == ref[s]) / len(common)
    ratio = sum(1 for mt in res.anc.seq if mt.pos < hi) / ref_trees
    _say(f"phase 3 golden gate (merge kernel): tree ratio {ratio:.4f}, "
         f"clade agreement {agree:.4f}, {len(common)} SNPs, {wall:.1f}s")
    if not (0.92 <= ratio <= 1.08 and agree >= 0.78):
        raise SystemExit("phase 3: golden gate failed")


def _four_cards(tmp: str) -> None:
    """Phase 5's four-card half, in this process, which holds the four
    cards: the CLI entry point with ``--devices 4``."""
    from relate_tpu.pipeline import cli
    from relate_tpu.utils import trace
    t0 = time.perf_counter()
    cli.main(_cli_args(os.path.join(tmp, "panel"), os.path.join(tmp, "four"),
                       PHASE5_MEMORY_GB) + ["--devices", "4"])
    _say(f"  CLI --mode All --devices 4: {time.perf_counter() - t0:.1f}s; "
         f"peak memory per card {trace.STAGES[-1].get('device_peak_mb')} MB")


def _child(phase: str, tmp: str = "") -> None:
    dev = _device_phase()
    if phase == "checks":
        _say("phase 2 kernels")
        for N in (2048, 5008):
            _merge_kernel_check(N)
        _paint_kernel_check(2048, 400)
        _paint_kernel_check(5008, 250)
        _painter_check()
        _golden_phase()
    else:
        if dev["count"] < 4:
            raise SystemExit(f"--devices 4: {dev['count']} card(s)")
        _four_cards(tmp)
    _say(DEVICE_TAG + json.dumps(dev))


# ---------------------------------------------------------------------------
# parent: no JAX backend here
# ---------------------------------------------------------------------------

def _run_child(cmd: list, timeout: float, env=None) -> dict:
    """Run a child phase, echoing its output as it comes (a run cut short
    still shows how far it got); returns the device it reported."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            text=True, env=env)
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    dev = None
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line.startswith(DEVICE_TAG):
                dev = json.loads(line[len(DEVICE_TAG):])
            else:
                _say(line)
        rc = proc.wait()
    finally:
        killer.cancel()
        _stop(proc)
    if rc != 0 or dev is None:
        raise SystemExit(f"child {' '.join(cmd[2:])!r} failed (exit {rc})")
    return dev


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _child_cmd(*args: str) -> list:
    return [sys.executable, os.path.abspath(__file__), "--child", *args]


def _write_panel(tmp: str) -> str:
    from relate_tpu.utils.synth import (synth_panel, write_flat_map,
                                        write_haps_sample)
    G, bp = synth_panel(SMOKE_N, SMOKE_L, seed=SMOKE_SEED)
    prefix = os.path.join(tmp, "panel")
    write_haps_sample(G, bp, prefix)
    write_flat_map(prefix + ".map", int(bp[-1]))
    return prefix


def _cli_args(prefix: str, out: str, memory_gb=None) -> list:
    args = ["--mode", "All", "--haps", prefix + ".haps",
            "--sample", prefix + ".sample", "--map", prefix + ".map",
            "-N", "30000", "-m", "1.25e-8", "--seed", "1", "-o", out]
    if memory_gb is not None:
        args += ["--memory", str(memory_gb)]
    return args


def _start_cli(prefix: str, out: str, memory_gb=None, env=None) -> tuple:
    """Start ``--mode All`` through the CLI in its own process; its output
    goes to files beside ``out``."""
    cmd = [sys.executable, "-m", "relate_tpu.pipeline.cli",
           *_cli_args(prefix, out, memory_gb)]
    with open(out + ".stdout", "w") as fo, open(out + ".stderr", "w") as fe:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fo, stderr=fe, env=env)
    return proc, out, time.perf_counter()


def _finish_cli(started: tuple, timeout: float, label: str) -> list:
    """Wait for a CLI process from :func:`_start_cli`; returns the stage
    trace lines it printed."""
    proc, out, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        rc = "killed at its time limit"
    finally:
        _stop(proc)
    wall = time.perf_counter() - t0
    with open(out + ".stdout") as fo, open(out + ".stderr") as fe:
        stdout, stderr = fo.read(), fe.read()
    if rc != 0:
        sys.stderr.write(stdout[-4000:] + stderr[-8000:])
        raise SystemExit(f"{label} exited {rc}")
    _say(f"  {label}: {wall:.1f}s in the process")
    return [ln for ln in stderr.splitlines()
            if ln.startswith("[trace]") and ": wall" in ln]


def _check_outputs(out: str) -> None:
    from relate_tpu.io import ancmut
    anc = ancmut.read_anc_text(out + ".anc")
    muts = ancmut.read_mut_final(out + ".mut")
    if len(anc.seq) < 1 or len(muts) != SMOKE_L:
        raise SystemExit(f"outputs: {len(anc.seq)} trees, {len(muts)} "
                         f"mutation records for {SMOKE_L} SNPs")
    _say(f"  outputs parse: {len(anc.seq)} trees, {len(muts)} records")


def _main_path(tmp: str) -> None:
    _say("phase 4 main path")
    prefix = _write_panel(tmp)
    out = os.path.join(tmp, "out")
    for line in _finish_cli(_start_cli(prefix, out), 600, "CLI --mode All"):
        _say("  " + line)
    _check_outputs(out)


def _last_card() -> str:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    return visible.split(",")[-1].strip() if visible else "3"


def _phase5(tmp: str) -> dict:
    """Four cards against one, run side by side: the one-card reference
    shares the last card with the four-card run, each process held to
    :data:`PHASE5_MEM_FRACTION` of it."""
    _say("phase 5 four cards vs one")
    prefix = _write_panel(tmp)
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION=PHASE5_MEM_FRACTION)
    one = _start_cli(prefix, os.path.join(tmp, "one"), PHASE5_MEMORY_GB,
                     dict(env, CUDA_VISIBLE_DEVICES=_last_card()))
    try:
        dev = _run_child(_child_cmd("four", tmp), timeout=1000, env=env)
        for line in _finish_cli(one, 1000, "CLI --mode All on one card"):
            _say("  " + line)
    finally:
        _stop(one[0])
    out4, out1 = os.path.join(tmp, "four"), os.path.join(tmp, "one")
    _check_outputs(out4)
    for ext in (".anc", ".mut"):
        with open(out4 + ext, "rb") as f4, open(out1 + ext, "rb") as f1:
            if f4.read() != f1.read():
                raise SystemExit(f"phase 5: {ext} differs between four cards "
                                 "and one")
    _say("  four-card .anc/.mut byte-identical to one card")
    return dev


def _card_line() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60)
    except FileNotFoundError:
        raise SystemExit("nvidia-smi not found: no NVIDIA GPU here")
    if proc.returncode != 0:
        raise SystemExit("nvidia-smi failed: " + proc.stderr.strip())
    return proc.stdout.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if ns.child:
        _child(*ns.child)
        return
    _say("card: " + _card_line().replace("\n", " | "))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if ns.devices == 4:
            dev = _phase5(tmp)
        else:
            dev = _run_child(_child_cmd("checks"), timeout=600)
            _main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
