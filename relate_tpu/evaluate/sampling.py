"""Branch-length posterior sampling and whole-chromosome re-estimation.

Behavioral reference: ``include/evaluate/coalescent_rate/
ReEstimateBranchLengths.cpp`` — ReEstimateBranchLengths (:35-407) reruns the
MCMC on a final .anc/.mut under a .coal prior; SampleBranchLengths
(:409-1107) draws posterior samples every ``num_proposals`` (default
``1000*max(N/10,10)``, :683) after an initial converged run, writing
per-sample anc/mut, newick, or the binary .timeb format.

On the device, all trees sample in lockstep (vmapped chains); a sample is a
device snapshot of the coordinate vectors.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np

from ..core import mcmc
from ..core.topology import MutationRecord
from ..core.trees import AncesTree, Tree


def _normalized_prior(epochs, rates):
    rts = np.asarray(rates, dtype=np.float64)
    pos = rts[np.isfinite(rts) & (rts > 0)]
    avg_ne = 1.0 / pos.mean()
    return avg_ne, np.where(np.isfinite(rts) & (rts > 0), rts, 0.0) * avg_ne, \
        np.asarray(epochs, dtype=np.float64) / avg_ne


def reestimate_branch_lengths(anc: AncesTree, muts: List[MutationRecord],
                              dist: np.ndarray, mu: float,
                              epochs: np.ndarray, rates: np.ndarray,
                              seed: int = 1,
                              group_rates: Optional[np.ndarray] = None,
                              memberships: Optional[np.ndarray] = None):
    """Re-run the branch-length MCMC under a .coal prior, in place.

    With ``group_rates`` (E, G, G) and per-haplotype ``memberships``, the
    prior uses pairwise group coalescence rates
    (EstimateBranchLengthsWithSampleAge::MCMCCoalRatesForRelate)."""
    avg_ne, r_norm, e_norm = _normalized_prior(epochs, rates)
    trees = [mt.tree for mt in anc.seq]
    group_R = None
    if group_rates is not None:
        # normalize the pair matrix by the same average Ne so times stay in
        # Ne-generations units (ReEstimateBranchLengths.cpp:202-218)
        gr = np.asarray(group_rates, dtype=np.float64)
        group_R = np.where(np.isfinite(gr) & (gr > 0), gr, 0.0) * avg_ne
    bl = mcmc.run_mcmc(trees, dist.astype(np.float64), len(muts),
                       Ne=avg_ne, mu=mu, seed=seed,
                       epochs=e_norm, rates=r_norm,
                       group_R=group_R, memberships=memberships)
    for i, mt in enumerate(anc.seq):
        mt.tree.branch_length = bl[i]
    return anc


def sample_branch_lengths(anc: AncesTree, muts: List[MutationRecord],
                          dist: np.ndarray, mu: float,
                          epochs: np.ndarray, rates: np.ndarray,
                          num_samples: int = 100,
                          num_proposals: Optional[int] = None,
                          seed: int = 1, mesh=None,
                          mesh_axis: str = "shard") -> np.ndarray:
    """Posterior samples of branch lengths for every tree.

    ``mesh``: optional device mesh — the independent chains (tree batch)
    are sharded over it, like run_mcmc.
    Returns (num_samples, num_trees, 2N-1) branch lengths in generations.
    """
    trees = [mt.tree for mt in anc.seq]
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    L = len(muts)
    cap = mcmc.chain_batch_cap(M)
    if B > cap:
        # slice oversized batches (same device-program bound as run_mcmc)
        from ..core.trees import AncesTree as _A
        outs = []
        for s in range(0, B, cap):
            sub = _A(N=anc.N, seq=anc.seq[s: s + cap],
                     sample_ages=anc.sample_ages)
            outs.append(sample_branch_lengths(
                sub, muts, dist, mu, epochs, rates,
                num_samples=num_samples, num_proposals=num_proposals,
                seed=seed + 7 * (s + 1), mesh=mesh, mesh_axis=mesh_axis))
        return np.concatenate(outs, axis=1)
    if num_proposals is None:
        num_proposals = 1000 * int(max(N / 10.0, 10.0))
    B_real = B
    if mesh is not None:
        # pad the chain batch to a device-count multiple (padded chains are
        # copies of the last tree; their draws are dropped)
        ndev = int(mesh.devices.size)
        pad = -B % ndev
        trees = trees + [trees[-1]] * pad
        B = len(trees)
    avg_ne, r_norm, e_norm = _normalized_prior(epochs, rates)
    delta = int(max(N / 10.0, 10.0))
    rng = np.random.default_rng(seed)

    # build chain state like run_mcmc
    E = len(e_norm)
    rt = np.broadcast_to(np.asarray(r_norm, dtype=np.float64), (B, E))
    cumR = np.zeros((B, E))
    widths = np.diff(e_norm)
    cumR[:, 1:] = np.cumsum(rt[:, : E - 1] * widths, axis=1)
    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, M)])
    kc2 = nl * (nl - 1) / 2.0
    parent = np.stack([t.parent for t in trees])
    st = mcmc.ChainStatic(
        parent=np.asarray(parent, np.int32),
        child_left=np.stack([t.child_left for t in trees]).astype(np.int32),
        child_right=np.stack([t.child_right for t in trees]).astype(np.int32),
        num_events=np.stack([t.num_events for t in trees]).astype(np.float32),
        mut_rate=mcmc.branch_mut_rates(trees, dist, L, avg_ne, mu),
        kc2_pos=kc2.astype(np.float32),
        epochs=np.asarray(e_norm, np.float32),
        rates=rt.astype(np.float32),
        cumR=cumR.astype(np.float32),
        depth=mcmc.tree_depths(parent).astype(np.int32))
    st = jax.tree.map(lambda x: jax.numpy.asarray(x), st)

    state, _ = mcmc.device_init_state(jax.numpy.asarray(st.parent), N,
                                      seed, st.depth)

    if mesh is not None:
        from ..parallel.mesh import shard_batch
        st = shard_batch(mesh, st, B, mesh_axis)
        state = shard_batch(mesh, state, B, mesh_axis)

    block = mcmc.get_block(N, M, True)
    key = jax.random.PRNGKey(seed)
    # burn-in to convergence (the reference's init=1 converged run,
    # SampleBranchLengths -> EstimateBranchLengths init pass) — one device
    # program, converged chains frozen (see mcmc.run_to_convergence)
    state, _, _ = block.run_to_convergence(st, state, key, 50 * delta,
                                           max(delta, 128), 2000)

    # num_proposals is a proposal budget in the reference's units; each
    # scan iteration delivers ~block.ppi proposals (single step + sweep)
    iters_per_sample = max(8, int(np.ceil(num_proposals / block.ppi)))
    out = np.empty((num_samples, B, M), dtype=np.float64)
    for s in range(num_samples):
        state = block.run(st, state, jax.random.fold_in(key, s + 1),
                          iters_per_sample, False)
        coords = np.asarray(state.coords, dtype=np.float64)
        bl = np.zeros((B, M))
        for b in range(B):
            p = parent[b]
            selp = p >= 0
            bl[b, selp] = avg_ne * (coords[b, p[selp]] - coords[b, selp])
        out[s] = np.maximum(bl, 0.0)
    return out[:, :B_real]


def write_newick_samples(path: str, anc: AncesTree, samples: np.ndarray,
                         tree_index: int = 0):
    """One newick line per posterior sample of one tree."""
    with open(path, "w") as f:
        for s in range(samples.shape[0]):
            t = anc.seq[tree_index].tree.copy()
            t.branch_length = samples[s, tree_index]
            f.write(t.to_newick() + "\n")


def write_timeb(path: str, anc: AncesTree, samples: np.ndarray,
                muts=None, bp=None, alleles=None):
    """Byte-compatible .timeb (SampleBranchLengthsBinary,
    ReEstimateBranchLengths.cpp:1310-1453 / parse_timeb.py):

    header ``int32 num_mapping_SNPs, int32 num_samples``; then per SNP with
    <= 1 mapped branch: ``int32 BP, char anc_allele, char der_allele,
    int32 DAF, int32 N``, followed by ``float32
    anctimes[num_samples * max(0, N-DAF-1)]`` (sorted coalescence ages of
    internal nodes outside the derived clade, excluding the mapped
    branch's parent, per sample) and ``float32
    dertimes[num_samples * max(0, DAF-1)]`` (sorted ages within the
    derived clade).

    Without ``muts`` (legacy call), every tree is written once as a
    root-mapped pseudo-SNP (DAF=N: all internal ages are dertimes)."""
    import struct

    S, T, M = samples.shape
    N = anc.N
    root = 2 * N - 2

    if muts is None:
        muts = []
        for t in range(T):
            from ..core.topology import MutationRecord
            muts.append(MutationRecord(tree=t, branch=[root]))
        bp = np.arange(T)
        alleles = ["N/N"] * T

    recs = [(snp, m) for snp, m in enumerate(muts) if len(m.branch) <= 1]
    # per (tree, sample): node ages from the sampled branch lengths
    age_cache = {}

    def ages_of(t, s):
        if (t, s) not in age_cache:
            tree = anc.seq[t].tree
            tree2 = tree.copy()
            tree2.branch_length = samples[s, t]
            age_cache[(t, s)] = tree2.coordinates(anc.sample_ages)
        return age_cache[(t, s)]

    with open(path, "wb") as f:
        f.write(struct.pack("ii", len(recs), S))
        for snp, m in recs:
            t = m.tree
            tree = anc.seq[t].tree
            leafmat = tree.leaf_matrix().astype(bool)
            al = alleles[snp] if alleles is not None else "N/N"
            anc_a = (al.split("/")[0] or "N")[0] if al else "N"
            der_a = (al.split("/")[1] or "N")[0] if "/" in al else "N"
            if len(m.branch) == 1:
                b = int(m.branch[0])
                daf = int(leafmat[b].sum()) if b != root else N
                sub = (leafmat & ~leafmat[b]).sum(axis=1) == 0
                par = int(tree.parent[b]) if b != root else -1
            else:
                daf = 0
                sub = np.zeros(tree.num_nodes, dtype=bool)
                par = -1
            internal = np.arange(N, 2 * N - 1)
            der_nodes = internal[sub[internal]]
            anc_nodes = np.asarray([v for v in internal
                                    if not sub[v] and v != par],
                                   dtype=np.int64)
            f.write(struct.pack("i", int(bp[snp]) if bp is not None
                                else snp))
            f.write(anc_a.encode()[:1] or b"N")
            f.write(der_a.encode()[:1] or b"N")
            f.write(struct.pack("ii", daf, N))
            anct = np.empty((S, len(anc_nodes)), dtype=np.float32)
            dert = np.empty((S, len(der_nodes)), dtype=np.float32)
            for s in range(S):
                coords = ages_of(t, s)
                anct[s] = np.sort(coords[anc_nodes])
                dert[s] = np.sort(coords[der_nodes])
            anct[:, : max(0, N - daf - 1)].tofile(f)
            dert[:, : max(0, daf - 1)].tofile(f)


def read_timeb(path: str):
    """parse_timeb.py equivalent: read a .timeb into a list of records
    {bp, anc_allele, der_allele, daf, N, anctimes (S, N-DAF-1),
    dertimes (S, DAF-1)}."""
    import struct
    out = []
    with open(path, "rb") as f:
        num_snps, S = struct.unpack("ii", f.read(8))
        for _ in range(num_snps):
            bp_v = struct.unpack("i", f.read(4))[0]
            anc_a = f.read(1).decode(errors="replace")
            der_a = f.read(1).decode(errors="replace")
            daf, N = struct.unpack("ii", f.read(8))
            na = max(0, N - daf - 1)
            nd = max(0, daf - 1)
            anct = np.fromfile(f, dtype=np.float32,
                               count=S * na).reshape(S, na)
            dert = np.fromfile(f, dtype=np.float32,
                               count=S * nd).reshape(S, nd)
            out.append({"bp": bp_v, "anc_allele": anc_a,
                        "der_allele": der_a, "daf": daf, "N": N,
                        "anctimes": anct, "dertimes": dert})
    return out
