"""Fully device-resident BuildTopology: one dispatch per section.

The host-driven builder (``topology.py``) replicates the reference's
control flow with a host/device round trip at every rebuild. This module
compiles the ENTIRE per-section SNP loop — mutation mapping, rebuild
decision, distance assembly, same-rpos/clade priors, the MinMatch merge
scan, accept/revert bookkeeping — into a single two-level ``lax.scan``
program (64-SNP blocks whose carrier counts come from one matmul each),
so a section is one device call regardless of length.

Matrix products here multiply 0/1 clade and carrier indicators: every
product and partial sum is a small integer, exact in TF32 and bf16 inputs
with f32 accumulation, so the default matmul precision is exact.

Semantics follow ``AncesTreeBuilder::BuildTopology``
(include/src/anc_builder.cpp:397-656) like topology.py, with one
documented deviation: the mutation-placement tie-break among equal-mismatch
candidates uses (clade size, node label) instead of the reference's DFS
post-order — both are deterministic "prefer-deeper" rules that differ only
on exact ties that the reference itself resolves via its candidate scan
order.

Non-mapping SNPs (is_mapping == 3) are flagged in the output and their
multi-branch force-mapping is filled in on the host afterwards (they are
rare: 0 on the reference example data).

Tree outputs stream out as per-step scan ys (flush flag, the closed
tree's event counts, the new tree's merge lists) plus per-SNP mutation
records; the host reconstitutes Tree objects from the merge lists. Sections
are padded to size buckets so all windows of a chunk share one compilation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import mapmutation
from .distance import DistanceAssembler, _assemble_ops
from .painting import Painter, Checkpoint
from .topology import MutationRecord, SectionResult
from .treebuilder import thresholds, tree_from_merges
from .trees import AncesTree, MarginalTree, Tree

INF = jnp.float32(np.inf)


class _Carry(NamedTuple):
    leafmat: jnp.ndarray      # (M, N) f32 clade indicators of current tree
    events: jnp.ndarray       # (M,) f32 current tree's event counts
    row: jnp.ndarray          # (N,) i32 distance-row state
    rpos_prev: jnp.ndarray    # (N,) f32
    num_tree: jnp.ndarray     # () i32


def _map_on_tree(leafmat, csize, car, tc, N, M, thr, cc=None):
    """Vectorized MapMutation (see mapmutation.py for the host twin).

    ``cc`` (the per-branch carrier counts ``leafmat @ car``) may be passed
    in precomputed — the section scan computes it for KB SNPs at a time in
    one matmul instead of re-streaming the (M, N) leafmat from device
    memory at every step (at N=5008 that stream is 200MB x 2 per SNP).
    Products/sums of 0/1 entries are exact at any matmul precision, so
    blocked and per-step results are bit-identical.

    Returns (is_mapping, branch, flipped, min_value)."""
    tnc = N - tc
    if cc is None:
        cc = leafmat @ car                  # (M,)
    icn = csize - cc
    nc_ = tc - cc
    cnc = tnc - icn

    tc_s = jnp.maximum(tc, 1e-9)
    tnc_s = jnp.maximum(tnc, 1e-9)
    is_leaf = jnp.arange(M) < N
    is_carrier = cc > 0.5

    den1 = cc + icn
    den2 = nc_ + cnc
    cond_u = (nc_ / tc_s < 0.3) & (icn / tnc_s < 0.3)
    cond_u &= (den1 <= 0) | (cc / jnp.maximum(den1, 1e-9) > 0.7)
    cond_u &= (den2 <= 0) | (cnc / jnp.maximum(den2, 1e-9) > 0.7)
    cond_f = (cc / tc_s < 0.3) & (cnc / tnc_s < 0.3)
    cond_f &= (den2 <= 0) | (nc_ / jnp.maximum(den2, 1e-9) > 0.7)
    cond_f &= (den1 <= 0) | (icn / jnp.maximum(den1, 1e-9) > 0.7)
    leaf_u = jnp.where(is_carrier, nc_ / tc_s < 0.3,
                       (nc_ / tc_s < 0.3) & (icn / tnc_s < 0.3))
    leaf_f = jnp.where(is_carrier,
                       (cc / tc_s < 0.3) & (cnc / tnc_s < 0.3),
                       cnc / tnc_s < 0.3)
    cond_u = jnp.where(is_leaf, leaf_u, cond_u)
    cond_f = jnp.where(is_leaf, leaf_f, cond_f)

    sum_u = nc_ + icn
    sum_f = cc + cnc
    BIG = jnp.float32(1e9)
    eff_u = jnp.where(cond_u, sum_u, BIG)
    eff_f = jnp.where(cond_f, sum_f, BIG)

    def pick(eff):
        m = eff.min()
        sub = jnp.where(eff == m,
                        csize * (M + 1) + jnp.arange(M, dtype=jnp.float32),
                        jnp.float32(np.inf))
        return m, jnp.argmin(sub).astype(jnp.int32)

    min_u, bu = pick(eff_u)
    min_f, bf = pick(eff_f)

    use_f = min_f < min_u               # exact tie -> unflipped (determ.)
    chosen_min = jnp.where(use_f, min_f, min_u)
    branch = jnp.where(use_f, bf, bu)
    ok = chosen_min <= thr
    is_mapping = jnp.where(ok, jnp.where(use_f, 2, 1), 3).astype(jnp.int8)
    flipped = ok & use_f
    branch = jnp.where(ok, branch, -1)
    minv = jnp.where(chosen_min >= BIG, INF, chosen_min)

    all_c = tc == N
    none_c = tc == 0
    is_mapping = jnp.where(all_c | none_c, 1, is_mapping).astype(jnp.int8)
    branch = jnp.where(all_c, M - 1, jnp.where(none_c, -1, branch))
    flipped = flipped & ~(all_c | none_c)
    minv = jnp.where(all_c | none_c, 0.0, minv)
    return is_mapping, branch, flipped, minv


def _merge_scan(d0, dcf0, use_cf, threshold, threshold_cf, key):
    """MinMatch merge scan emitting merges AND clade masks (device twin of
    treebuilder._quick_build_scan, extended with leafmat output)."""
    N = d0.shape[0]
    eye = jnp.eye(N, dtype=bool)

    def step(carry, t):
        d, dcf, active, sizes, conv, csets = carry
        mask2 = active[:, None] & active[None, :] & ~eye
        dm = jnp.where(mask2, d, INF)
        mv = dm.min(axis=1) + threshold
        within = d <= mv[:, None]
        mutual = mask2 & within & within.T
        dcfm = jnp.where(mask2, dcf, INF)
        mvcf = dcfm.min(axis=1) + threshold_cf
        within_cf = dcf <= mvcf[:, None]
        cfmut = within_cf & within_cf.T
        score = jnp.where(use_cf & cfmut, 0.0, d + d.T)
        eff_mut = jnp.where(mutual, score, INF)
        have = jnp.isfinite(eff_mut).any()
        eff_sym = jnp.where(mask2, d + d.T, INF)
        eff = jnp.where(have, eff_mut, eff_sym)
        tie = jax.random.uniform(jax.random.fold_in(key, t), (N, N))
        tie = jnp.minimum(tie, tie.T)
        m = eff.min()
        tsel = jnp.where(eff == m, tie, INF)
        flat = jnp.argmin(tsel.reshape(-1))
        a, b = flat // N, flat % N
        i = jnp.minimum(a, b).astype(jnp.int32)
        j = jnp.maximum(a, b).astype(jnp.int32)
        w = sizes[i] / (sizes[i] + sizes[j])
        d = d.at[j, :].set(w * d[i, :] + (1 - w) * d[j, :])
        d = d.at[:, j].set(w * d[:, i] + (1 - w) * d[:, j])
        dcf = dcf.at[j, :].set(w * dcf[i, :] + (1 - w) * dcf[j, :])
        dcf = dcf.at[:, j].set(w * dcf[:, i] + (1 - w) * dcf[:, j])
        clade = csets[i] + csets[j]
        csets = csets.at[j].set(clade)
        ci = conv[i]
        cj = conv[j]
        sizes = sizes.at[j].add(sizes[i])
        active = active.at[i].set(False)
        conv = conv.at[j].set(N + t)
        return (d, dcf, active, sizes, conv, csets), (ci, cj, clade)

    csets0 = jnp.eye(N, dtype=jnp.float32)
    init = (d0, dcf0, jnp.ones(N, bool), jnp.ones(N, jnp.float32),
            jnp.arange(N, dtype=jnp.int32), csets0)
    _, (cis, cjs, clades) = jax.lax.scan(step, init,
                                         jnp.arange(N - 1))
    return cis, cjs, clades


def use_merge_kernel(backend: Optional[str] = None) -> bool:
    """Whether the section builder merges with the incremental kernel
    (ops/merge_scan_inc.py): on a GPU, for every N; every other backend
    runs the XLA twin."""
    return (backend or jax.default_backend()) == "gpu"


_KERNEL_CACHE: dict = {}


def make_section_kernel(model_theta: float, N: int, L: int, mode: int,
                        use_kernel: Optional[bool] = None,
                        interpret: bool = False):
    """Compile the full section builder as one jitted program (process-
    cached by the static configuration — a fresh jit per call re-traces
    and re-lowers the whole section scan, ~2s of host time each).

    Tree outputs are emitted as per-step scan ys (flush flag + the closed
    tree's events + the new tree's merge lists), NOT carried buffers — scan
    ys are written in place, while large carry buffers updated inside
    lax.cond would be copied every step.

    The merge scan is the incremental kernel when ``use_kernel`` (default:
    :func:`use_merge_kernel`), else the XLA twin `_merge_scan`. Tie-break
    draws differ between the two (seed-level noise either way);
    ``interpret`` runs the kernel in Pallas interpret mode (tests).
    """
    if use_kernel is None:
        use_kernel = use_merge_kernel()
    ck = (float(model_theta), N, L, mode, bool(use_kernel), interpret)
    cached = _KERNEL_CACHE.get(ck)
    if cached is not None:
        return cached

    M = 2 * N - 1
    thr_map = 0.03 * N
    threshold, threshold_cf = thresholds(model_theta)
    val = -float(np.log(model_theta / (1.0 - model_theta)))
    use_cf_mode = mode == 1

    if use_kernel:
        from ..ops.merge_scan_inc import merge_scan_incremental

        def _ms(mat, dcf, ucf, thr, thrcf, k):
            seed = jax.random.randint(k, (), 0, np.int32(2**31 - 1))
            return merge_scan_incremental(mat, dcf, ucf, thr, thrcf, seed,
                                          interpret=interpret)
    else:
        def _ms(mat, dcf, ucf, thr, thrcf, k):
            return _merge_scan(mat, dcf, jnp.bool_(ucf), thr, thrcf, k)

    def kernel(topology, logscale, row0, rpos_prev0, car_mat, state_vec,
               force_vec, rpos_vec, nxt_mat, snps, valid_vec, first_mat0,
               key):

        def assemble(row, car_f, rp_prev, rp_next, rpos_snp, is_fl):
            is_exact = (car_f > 0.5) | is_fl
            denom = rp_next - rp_prev
            same = denom == 0
            safe = jnp.where(same, 1.0, denom)
            wl = jnp.where(same, 0.5, (rp_next - rpos_snp) / safe)
            wr = jnp.where(same, 0.5, (rpos_snp - rp_prev) / safe)
            kcol = jnp.arange(N, dtype=jnp.int32)
            return _assemble_ops(topology, logscale, row.astype(jnp.int32),
                                 is_exact, wl.astype(jnp.float32),
                                 wr.astype(jnp.float32), kcol)

        # SNPs are processed in blocks of KB: each block's per-branch
        # carrier counts (leafmat @ car) are computed in ONE matmul and
        # refreshed only when a rebuild replaces the tree mid-block.
        # Per-step work then touches (M,) vectors instead of streaming the
        # (M, N) leafmat from device memory twice per SNP (2 x 200MB per
        # step at N=5008). The 0/1 operands keep every matmul precision
        # exact, so results are bit-identical to the per-step formulation.
        KB = 64

        def inner_step(cext, xs):
            c, csize, ccb, car_blk_f = cext
            (kk, snp, car, state_flag, force_flag, rpos_snp, nxt_row, valid,
             is_first, skey) = xs
            car_f = car.astype(jnp.float32)
            tc = car_f.sum()

            adv = valid & ~is_first
            row = c.row + jnp.where(adv, car.astype(jnp.int32), 0)
            rpos_prev = jnp.where(adv & (car > 0), rpos_snp, c.rpos_prev)
            c = c._replace(row=row, rpos_prev=rpos_prev)

            cc = jax.lax.dynamic_slice_in_dim(ccb, kk, 1, axis=1)[:, 0]
            im, branch, flipped, minv = _map_on_tree(
                c.leafmat, csize, car_f, tc, N, M, thr_map, cc=cc)

            add_ev = ((im <= 2) & (branch >= 0)
                      & (((branch == M - 1) & (tc == N))
                         | (state_flag > 0)))
            events = c.events.at[jnp.maximum(branch, 0)].add(
                jnp.where(add_ev & valid, 1.0, 0.0))
            c = c._replace(events=events)

            do_rebuild = valid & ~is_first & ((im > 1) | force_flag)

            def rebuild(ca):
                c, csize, ccb = ca
                mat = assemble(c.row, car_f, c.rpos_prev, nxt_row, rpos_snp,
                               (snp == 0) | (snp == L - 1))
                mat = mat + val * car_f[:, None] * (1.0 - car_f[None, :])
                member = c.leafmat[N:]
                dcf = val * (member.T @ (1.0 - member))
                cis, cjs, clades = _ms(
                    mat, dcf, use_cf_mode, jnp.float32(threshold),
                    jnp.float32(threshold_cf), skey)
                new_leafmat = jnp.concatenate(
                    [jnp.eye(N, dtype=jnp.float32), clades], axis=0)

                csize2 = new_leafmat.sum(axis=1)
                im2, b2, fl2, minv2 = _map_on_tree(
                    new_leafmat, csize2, car_f, tc, N, M, thr_map)
                revert = (im2 > 1) & (minv2 >= minv) & ~force_flag

                was_prev = (((im == 2) | ((im == 1) & force_flag))
                            & (branch >= 0))
                ev_flush = c.events.at[jnp.maximum(branch, 0)].add(
                    jnp.where(was_prev & (state_flag > 0), -1.0, 0.0))
                add2 = ((im2 <= 2) & (b2 >= 0)
                        & (((b2 == M - 1) & (tc == N)) | (state_flag > 0)))
                new_events = jnp.zeros((M,), jnp.float32).at[
                    jnp.maximum(b2, 0)].add(jnp.where(add2, 1.0, 0.0))

                merges = jnp.stack([cis, cjs], axis=1)
                acc = c._replace(leafmat=new_leafmat, events=new_events,
                                 num_tree=c.num_tree + 1)
                out_acc = (jnp.bool_(True), ev_flush, merges,
                           im2.astype(jnp.int8), b2, fl2, c.num_tree)
                out_rev = (jnp.bool_(False), ev_flush, merges,
                           im.astype(jnp.int8), branch, fl2,
                           c.num_tree - 1)
                cout = jax.tree.map(lambda a, b: jnp.where(revert, a, b),
                                    c, acc)
                rec = tuple(jnp.where(revert, a, b)
                            for a, b in zip(out_rev, out_acc))
                # refresh the block's carrier counts against the new tree
                ccb2 = new_leafmat @ car_blk_f.T
                csize_out = jnp.where(revert, csize, csize2)
                ccb_out = jnp.where(revert, ccb, ccb2)
                return (cout, csize_out, ccb_out), rec

            def norebuild(ca):
                c, csize, ccb = ca
                zm = jnp.zeros((N - 1, 2), jnp.int32)
                return (c, csize, ccb), (jnp.bool_(False), c.events, zm,
                                         im.astype(jnp.int8), branch,
                                         flipped, c.num_tree - 1)

            (c2, csize2, ccb2), rec = jax.lax.cond(
                do_rebuild, rebuild, norebuild, (c, csize, ccb))
            return (c2, csize2, ccb2, car_blk_f), rec

        def outer_step(cext, xs_blk):
            c, csize = cext
            car_blk_f = xs_blk[1].astype(jnp.float32)       # (KB, N)
            ccb = c.leafmat @ car_blk_f.T                   # (M, KB)
            kks = jnp.arange(KB, dtype=jnp.int32)
            (c, csize, _, _), recs = jax.lax.scan(
                inner_step, (c, csize, ccb, car_blk_f), (kks,) + xs_blk)
            return (c, csize), recs

        # first tree: plain build from the start-SNP matrix
        cis, cjs, clades = _ms(
            first_mat0, jnp.zeros_like(first_mat0), False,
            jnp.float32(threshold), jnp.float32(threshold_cf),
            jax.random.fold_in(key, 0))
        leafmat = jnp.concatenate([jnp.eye(N, dtype=jnp.float32), clades],
                                  axis=0)
        first_merges = jnp.stack([cis, cjs], axis=1)

        c = _Carry(leafmat=leafmat, events=jnp.zeros((M,), jnp.float32),
                   row=row0, rpos_prev=rpos_prev0, num_tree=jnp.int32(1))

        S = len(snps)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i + 1))(
            jnp.arange(S))
        is_first = jnp.zeros(S, bool).at[0].set(True)
        xs = (snps, car_mat, state_vec, force_vec, rpos_vec, nxt_mat,
              valid_vec, is_first, keys)
        # (S, ...) -> (S//KB, KB, ...) blocks for the two-level scan
        # (the caller pads S to a power-of-two bucket >= 64)
        xs_blk = jax.tree.map(
            lambda a: a.reshape((S // KB, KB) + a.shape[1:]), xs)
        csize0 = c.leafmat.sum(axis=1)
        (c, _), recs = jax.lax.scan(outer_step, (c, csize0), xs_blk)
        recs = jax.tree.map(
            lambda a: a.reshape((S,) + a.shape[2:]), recs)
        return first_merges, c.events, c.num_tree, recs

    jitted = jax.jit(kernel)
    _KERNEL_CACHE[ck] = jitted
    return jitted


def next_derived_rpos(G: np.ndarray, rpos: np.ndarray) -> np.ndarray:
    """NXT[l, n] = rpos of the first derived site of n at/after l (or the
    last SNP) — the fresh-value equivalent of the reference's lazily
    refreshed v_rpos_next (anc_builder.cpp:139-147)."""
    L, N = G.shape
    idx = np.where(G == 1, np.arange(L, dtype=np.int32)[:, None],
                   np.int32(L - 1))
    m = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    return np.asarray(rpos, dtype=np.float64)[m].astype(np.float32)


def build_topology_section_device(painter: Painter, cp: Checkpoint,
                                  G: np.ndarray, rpos: np.ndarray,
                                  state: np.ndarray, bp: np.ndarray,
                                  start: int, end: int, seed: int,
                                  mode: int = 1, fb: int = 0,
                                  kernel=None) -> SectionResult:
    """Device-resident BuildTopology for one window [start, end]."""
    L, N = G.shape
    S = end - start + 1

    nxt_full = next_derived_rpos(G, rpos)
    paint = painter.repaint(cp)
    assembler = DistanceAssembler(G, rpos, nxt=nxt_full)
    dstate = assembler.init_state(paint.plan, start)

    car = G[start:end + 1].astype(np.uint8).copy()
    car[S - 1] = 0
    force = np.zeros(S, dtype=bool)
    if fb > 0:
        idxs = np.arange(start + 1, end)
        force[idxs - start] = (bp[idxs + 1] // fb - bp[idxs] // fb) >= 1

    nxt = nxt_full[start:end + 1]
    if kernel is None:
        kernel = make_section_kernel(painter.model.theta, N, L, mode)

    mat0 = assembler.get_matrix(paint, dstate, start,
                                is_first_or_last=(start == 0
                                                  or start == L - 1))

    # pad the SNP axis to a size bucket so all sections of a chunk share
    # one compilation (padded steps are no-ops via the valid mask)
    SP = 1 << max(int(np.ceil(np.log2(max(S, 64)))), 6)
    pad = SP - S

    def padv(a, fill=0):
        if pad == 0:
            return a
        w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, w, constant_values=fill)

    valid = np.zeros(SP, dtype=bool)
    valid[:S] = True

    first_merges, last_events, num_tree, recs = kernel(
        paint.topology, paint.logscale,
        jnp.asarray(dstate.row, jnp.int32),
        jnp.asarray(dstate.rpos_prev, jnp.float32),
        jnp.asarray(padv(car)),
        jnp.asarray(padv(state[start:end + 1]), jnp.int32),
        jnp.asarray(padv(force)),
        jnp.asarray(padv(rpos[start:end + 1]), jnp.float32),
        jnp.asarray(padv(nxt)),
        jnp.asarray(padv(np.arange(start, end + 1), fill=end), jnp.int32),
        jnp.asarray(valid), jnp.asarray(mat0),
        jax.random.PRNGKey(seed))

    # download the small per-step records; gather the large flush-only
    # arrays (events, merge lists) on device first — only ~num_tree of the
    # SP rows are meaningful, and host<->device bandwidth is precious
    flush = np.asarray(recs[0])[:S]
    im_arr, b_arr, fl_arr, t_arr = (np.asarray(x)[:S] for x in recs[3:7])
    first_merges = np.asarray(first_merges)
    last_events = np.asarray(last_events)
    num_tree = int(num_tree)

    # reconstitute trees: tree 0 from first_merges; tree t>0 from the flush
    # at its creating step; tree t's events come from the NEXT flush (or the
    # final carry for the last tree)
    flush_steps = np.nonzero(flush)[0]
    assert len(flush_steps) == num_tree - 1, (len(flush_steps), num_tree)
    fs_dev = jnp.asarray(flush_steps, jnp.int32)
    ev_flush_f = np.asarray(jnp.take(recs[1], fs_dev, axis=0))
    merges_f = np.asarray(jnp.take(recs[2], fs_dev, axis=0))
    merge_list = [first_merges] + [merges_f[k]
                                   for k in range(len(flush_steps))]
    event_list = [ev_flush_f[k] for k in range(len(flush_steps))] \
        + [last_events]
    pos_list = [start] + [start + int(i) for i in flush_steps]

    seq = []
    for t in range(num_tree):
        tr = tree_from_merges(merge_list[t][:, 0], merge_list[t][:, 1], N)
        tr.num_events = event_list[t].astype(np.float32)
        tr.SNP_begin[:] = pos_list[t]
        tr.SNP_end[:] = (pos_list[t + 1] if t + 1 < num_tree else end)
        seq.append(MarginalTree(pos=int(pos_list[t]), tree=tr))
    anc = AncesTree(N=N, seq=seq)

    muts = []
    for i in range(S):
        rec = MutationRecord(tree=int(t_arr[i]), flipped=bool(fl_arr[i]))
        if im_arr[i] <= 2 and b_arr[i] >= 0:
            rec.branch = [int(b_arr[i])]
        elif im_arr[i] > 2:
            tr = anc.seq[rec.tree].tree
            brs, flp = mapmutation.force_map_mutation(
                tr, car[i].astype(bool))
            rec.branch = brs
            rec.flipped = flp
        muts.append(rec)
    return SectionResult(anc=anc, muts=muts, start=start, end=end)
