"""Tree-sequence topology building along a window ("section").

Behavioral reference: ``AncesTreeBuilder::BuildTopology``
(``include/src/anc_builder.cpp:397-656``). Control flow per SNP:

1. try to map the SNP's carriers onto the current marginal tree;
2. if it maps to a single branch (possibly allele-flipped), record it and
   (for transversions / ``state`` SNPs) count the event on that branch;
3. otherwise (or on a ``--fb`` force interval) build a *candidate* new tree
   from the distance matrix at this SNP — with the same-rpos carrier penalty
   (anc_builder.cpp:555-581) and the previous tree's clade-consistency prior
   (anc_builder.cpp:583-608) — and keep it only if the SNP maps at least as
   well as on the old tree (anc_builder.cpp:621-646);
4. non-mappable SNPs get the multi-branch force-mapping
   (``is_not_mapping`` in the .mut output).

Device batching: mapping is evaluated for *blocks* of SNPs against the
current tree in one call (matmul over the clade matrix); the sequential
dependency only re-enters at rebuild SNPs, so device work is proportional to
the number of trees, not the number of SNPs.

Replicated reference quirks (bit-parity with the oracle):
- carriers are collected for snp in [start, end) — the final SNP of a
  section is always treated as carrying no mutation (anc_builder.cpp:408);
- on revert after a flipped mapping, the recorded ``flipped`` flag keeps the
  candidate tree's value (the reference's ``flipped == 1`` statement at
  anc_builder.cpp:625 is a comparison, not an assignment).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from . import mapmutation
from .distance import DistanceAssembler
from .painting import Painter, Checkpoint
from .treebuilder import (clade_prior_matrix, make_fused_rebuild,
                          quick_build, same_rpos_penalty, tree_from_merges)
from .trees import AncesTree, MarginalTree, Tree


@dataclass
class MutationRecord:
    tree: int = 0
    branch: List[int] = field(default_factory=list)
    flipped: bool = False
    age_begin: float = 0.0
    age_end: float = 0.0

    @property
    def is_not_mapping(self) -> bool:
        return len(self.branch) > 1


@dataclass
class SectionResult:
    anc: AncesTree
    muts: List[MutationRecord]   # for snps [start, end]
    start: int
    end: int


def build_topology_section(painter: Painter, cp: Checkpoint,
                           G: np.ndarray, rpos: np.ndarray,
                           state: np.ndarray, bp: np.ndarray,
                           start: int, end: int, seed: int,
                           mode: int = 1, ancestral_state: bool = True,
                           fb: int = 0,
                           sample_ages: Optional[np.ndarray] = None
                           ) -> SectionResult:
    """Build the tree sequence for one window [start, end] (inclusive)."""
    L, N = G.shape
    rng = np.random.default_rng(seed)
    rng_flip = None if ancestral_state else rng

    paint = painter.repaint(cp)
    assembler = DistanceAssembler(G, rpos)
    dstate = assembler.init_state(paint.plan, start)

    # carriers matrix for the section; final SNP forced empty (quirk)
    car = G[start:end + 1].astype(np.uint8).copy()
    car[end - start] = 0

    def build_first():
        mat = assembler.get_matrix(paint, dstate, start,
                                   is_first_or_last=(start == 0
                                                     or start == L - 1))
        if not ancestral_state:
            mat = 0.5 * (mat + mat.T)
        t = quick_build(mat, theta=painter.model.theta,
                        seed=int(rng.integers(1 << 31)),
                        sample_ages=sample_ages)
        t.SNP_begin[:] = start
        return t

    tree = build_first()
    leafmat = tree.leaf_matrix()
    leafmat_dev = jnp.asarray(leafmat)
    kcol_dev = jnp.asarray(np.arange(N, dtype=np.int32))
    fused = make_fused_rebuild(painter.model.theta, N, mode, ancestral_state)
    muts: List[MutationRecord] = [MutationRecord() for _ in range(end - start + 1)]
    anc = AncesTree(N=N, seq=[MarginalTree(pos=start, tree=tree)])

    def apply_mapping(t: Tree, snp: int, res_i, rec: MutationRecord):
        """Record a block-map result for one SNP and update num_events."""
        im = int(res_i.is_mapping)
        b = int(res_i.branch)
        rec.flipped = bool(res_i.flipped)
        if im in (1, 2):
            rec.branch = [b] if b >= 0 else []
            if b == 2 * N - 2 and int(car_row_sum[snp - start]) == N:
                t.num_events[b] += 1.0       # root case: always counted
            elif b >= 0 and state[snp]:
                t.num_events[b] += 1.0
        return im

    car_row_sum = car.sum(axis=1)

    # map the first SNP
    res0 = mapmutation.map_mutations_block(tree, leafmat, car[:1], rng_flip)
    muts[0].tree = 0
    im0 = apply_mapping(tree, start, _row(res0, 0), muts[0])
    if im0 > 2:
        brs, flp = mapmutation.force_map_mutation(tree, car[0].astype(bool))
        muts[0].branch = brs
        muts[0].flipped = flp

    num_tree = 1
    s = start + 1
    # precompute force-build flags (anc_builder.cpp:522-526)
    force = np.zeros(end - start + 1, dtype=bool)
    if fb > 0:
        idxs = np.arange(start + 1, end)
        force[idxs - start] = (bp[idxs + 1] // fb - bp[idxs] // fb) >= 1

    BLOCK = 1024   # mapping-evaluation block; bounds rework after rebuilds
    while s <= end:
        blk_end = min(s - start + BLOCK, end - start + 1)
        blk = slice(s - start, blk_end)
        res = mapmutation.map_mutations_block(tree, leafmat, car[blk],
                                              rng_flip)
        bad_rel = np.nonzero((res.is_mapping > 1) | force[blk])[0]
        n_ok = bad_rel[0] if len(bad_rel) else (blk_end - (s - start))

        # commit cleanly-mapped SNPs s .. s+n_ok-1
        for i in range(n_ok):
            snp = s + i
            rec = muts[snp - start]
            rec.tree = num_tree - 1
            apply_mapping(tree, snp, _row(res, i), rec)
        # advance distance-row state through the committed range (and the
        # rebuild SNP itself, whose carriers advance before GetMatrix)
        upto = s + n_ok if len(bad_rel) else s + n_ok - 1
        if upto >= s:
            _advance_state(dstate, car, rpos, start, s, min(upto, end))
        if not len(bad_rel):
            s = s + n_ok
            continue

        snp = s + n_ok
        rec = muts[snp - start]
        rec.tree = num_tree - 1
        r = _row(res, n_ok)
        im = apply_mapping(tree, snp, r, rec)
        min_value = float(r.min_value)
        frc = bool(force[snp - start])
        prev_branch = rec.branch[0] if (im == 2 or (im == 1 and frc)) and rec.branch else -1

        # build candidate tree: distance assembly + penalties + previous
        # tree's clade prior + merge scan fused in one device dispatch
        if sample_ages is None:
            rows, is_exact, wl, wr = assembler.matrix_inputs(
                dstate, snp, (snp == 0 or snp == L - 1))
            cis, cjs = fused(paint.topology, paint.logscale,
                             jnp.asarray(rows), jnp.asarray(is_exact),
                             jnp.asarray(wl), jnp.asarray(wr), kcol_dev,
                             jnp.asarray(car[snp - start]), leafmat_dev,
                             jax.random.PRNGKey(int(rng.integers(1 << 31))))
            newtree = tree_from_merges(np.asarray(cis), np.asarray(cjs), N)
        else:
            # sample-ages variant: unfused path with the age-aware builder
            mat = assembler.get_matrix(paint, dstate, snp,
                                       is_first_or_last=(snp == 0
                                                         or snp == L - 1))
            if not ancestral_state:
                mat = 0.5 * (mat + mat.T)
            theta = painter.model.theta
            mat = same_rpos_penalty(mat, [np.nonzero(car[snp - start])[0]],
                                    theta)
            d_cf = clade_prior_matrix(tree, theta) if mode == 1 else None
            newtree = quick_build(mat, d_cf=d_cf, theta=theta,
                                  seed=int(rng.integers(1 << 31)),
                                  sample_ages=sample_ages)
        new_leafmat = newtree.leaf_matrix()
        new_leafmat_dev = jnp.asarray(new_leafmat)
        res_alt = mapmutation.map_mutations_block(
            newtree, new_leafmat, car[snp - start: snp - start + 1], rng_flip)
        ra = _row(res_alt, 0)
        im_alt = int(ra.is_mapping)
        min_alt = float(ra.min_value)

        if im_alt > 1 and min_alt >= min_value and not frc:
            # keep old tree (anc_builder.cpp:621-629)
            if im == 2:
                rec.branch = [prev_branch]
                rec.flipped = bool(ra.flipped)   # reference quirk (== bug)
            if im > 2:
                brs, flp = mapmutation.force_map_mutation(
                    tree, car[snp - start].astype(bool))
                rec.branch = brs
                rec.flipped = flp
        else:
            # accept new tree (anc_builder.cpp:630-646)
            im_new = apply_mapping(newtree, snp, ra, rec)
            if (im == 2 or (im == 1 and frc)) and prev_branch >= 0 \
                    and state[snp]:
                tree.num_events[prev_branch] -= 1.0
            if im_alt > 2:
                brs, flp = mapmutation.force_map_mutation(
                    newtree, car[snp - start].astype(bool))
                rec.branch = brs
                rec.flipped = flp
            rec.tree = num_tree
            tree.SNP_end[:] = snp
            newtree.SNP_begin[:] = snp
            anc.seq.append(MarginalTree(pos=snp, tree=newtree))
            tree = newtree
            leafmat = new_leafmat
            leafmat_dev = new_leafmat_dev
            num_tree += 1

        s = snp + 1

    tree.SNP_end[:] = end
    return SectionResult(anc=anc, muts=muts, start=start, end=end)


def _row(res: mapmutation.MapResult, i: int):
    class _R:
        pass
    r = _R()
    r.is_mapping = res.is_mapping[i]
    r.branch = res.branch[i]
    r.flipped = res.flipped[i]
    r.min_value = res.min_value[i]
    return r


def _advance_state(dstate, car, rpos, start, s, upto):
    """Advance v_snp_prev / v_rpos_prev through snps [s, upto] inclusive."""
    lo = s - start
    hi = upto - start + 1
    block = car[lo:hi]                       # (n, N)
    counts = block.sum(axis=0).astype(np.int64)
    dstate.row[:] += counts
    # last carrier snp per target within the block
    n, N = block.shape
    if n > 0:
        rev = block[::-1].argmax(axis=0)
        has = block.any(axis=0)
        last_rel = (n - 1 - rev)
        snps = s + last_rel
        dstate.rpos_prev[has] = rpos[snps[has]]
