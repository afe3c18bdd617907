"""MinMatch hierarchical tree building — vectorized JAX implementation.

Behavioral reference: ``MinMatch::QuickBuild``
(``include/src/tree_builder.cpp:1061-1303,2357-2644``). The C++ maintains
per-row candidate caches updated incrementally (a CPU optimization); the
device formulation recomputes the selection criterion each merge step as
masked matrix reductions, which vectorizes over a *batch of trees*
(the per-tree merge loop is sequential, the tree axis is the parallel one).

Selection semantics per merge step (N-1 steps):
- ``min_values[i] = min_{j active} d[i,j] + threshold`` with
  ``threshold = -0.2 log(theta/(1-theta))`` ("0.1 of a mutation",
  tree_builder.cpp:43).
- A pair (i,j) is a *candidate* iff mutually within threshold of both row
  minima (tree_builder.cpp:92-94).
- Candidate score = d[i,j]+d[j,i]; with a consistency prior d_CF, pairs that
  are also mutually-min in d_CF (threshold_CF = -0.001 log(theta/(1-theta)))
  score 0 (tree_builder.cpp:1698-1702) — clades of the previous tree are
  preferred.
- No candidate at all -> fall back to the global argmin of the symmetrized
  matrix (tree_builder.cpp:1167-1178; sym_d == d + d^T is invariant under
  the weighted-average merge, so no separate matrix is kept here).
- Ties break by a seeded uniform draw (tree_builder.cpp:113-125), then by
  (i,j) order for full determinism.
- Merge: new cluster's distances are the cluster-size-weighted averages of
  its parts (tree_builder.cpp:319-323).

With sample ages, merges below the current heuristic coalescent age bound
are preferred (dist3 logic, tree_builder.cpp:7-21,205-239): implemented via
an age penalty channel.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .trees import Tree, children_from_parent

INF = jnp.float32(np.inf)


def thresholds(theta: float) -> Tuple[float, float]:
    base = -float(np.log(theta / (1.0 - theta)))
    return 0.2 * base, 0.001 * base


@functools.partial(jax.jit, static_argnames=("use_cf", "use_ages"))
def _quick_build_scan(d0, dcf0, key, threshold, threshold_cf,
                      sample_ages, age_grid, use_cf: bool, use_ages: bool):
    """Run N-1 merge steps; returns (child_i (N-1,), child_j (N-1,)) as
    *cluster-row* indices plus the conv bookkeeping resolved on device.

    All arrays float32; d is (N, N).
    """
    N = d0.shape[0]
    eye = jnp.eye(N, dtype=bool)

    def step(carry, t):
        d, dcf, active, sizes, conv, ages = carry
        mask2 = active[:, None] & active[None, :] & ~eye

        dm = jnp.where(mask2, d, INF)
        mv = dm.min(axis=1) + threshold
        within = d <= mv[:, None]            # within[i,j]: d[i,j] <= mv[i]
        mutual = mask2 & within & within.T   # and d[j,i] <= mv[j]

        if use_cf:
            dcfm = jnp.where(mask2, dcf, INF)
            mvcf = dcfm.min(axis=1) + threshold_cf
            within_cf = dcf <= mvcf[:, None]
            cfmut = within_cf & within_cf.T
            score = jnp.where(cfmut, 0.0, d + d.T)
        else:
            score = d + d.T

        if use_ages:
            # pairs whose max sample age exceeds the current age bound are
            # deprioritized (reference "replace" flag ordering)
            pair_age = jnp.maximum(ages[:, None], ages[None, :])
            age_ok = pair_age <= age_grid[t]
            score = jnp.where(age_ok, score, score + jnp.float32(1e20))

        eff_mut = jnp.where(mutual, score, INF)
        have = jnp.isfinite(eff_mut).any()
        eff_sym = jnp.where(mask2, d + d.T, INF)
        eff = jnp.where(have, eff_mut, eff_sym)

        # lexicographic argmin (eff, tie_random, flat index)
        tie = jax.random.uniform(jax.random.fold_in(key, t), (N, N))
        tie = jnp.minimum(tie, tie.T)        # symmetric tiebreak per pair
        m = eff.min()
        cand = eff == m
        tsel = jnp.where(cand, tie, INF)
        flat = jnp.argmin(tsel.reshape(-1))
        a, b = flat // N, flat % N
        i = jnp.minimum(a, b)
        j = jnp.maximum(a, b)

        w = sizes[i] / (sizes[i] + sizes[j])
        new_row = w * d[i, :] + (1 - w) * d[j, :]
        new_col = w * d[:, i] + (1 - w) * d[:, j]
        d = d.at[j, :].set(new_row)
        d = d.at[:, j].set(new_col)
        if use_cf:
            new_row_cf = w * dcf[i, :] + (1 - w) * dcf[j, :]
            new_col_cf = w * dcf[:, i] + (1 - w) * dcf[:, j]
            dcf = dcf.at[j, :].set(new_row_cf)
            dcf = dcf.at[:, j].set(new_col_cf)

        ci = conv[i]
        cj = conv[j]
        sizes = sizes.at[j].add(sizes[i])
        active = active.at[i].set(False)
        conv = conv.at[j].set(N + t)
        if use_ages:
            ages = ages.at[j].set(jnp.maximum(ages[i], ages[j]))

        return (d, dcf, active, sizes, conv, ages), (ci, cj)

    sizes0 = jnp.ones(N, jnp.float32)
    conv0 = jnp.arange(N, dtype=jnp.int32)
    active0 = jnp.ones(N, dtype=bool)
    ages0 = sample_ages
    (_, _, _, _, _, _), (cis, cjs) = jax.lax.scan(
        step, (d0, dcf0, active0, sizes0, conv0, ages0),
        jnp.arange(N - 1))
    return cis, cjs


def quick_build(d: np.ndarray, d_cf: Optional[np.ndarray] = None,
                theta: float = 0.001, seed: int = 1,
                sample_ages: Optional[np.ndarray] = None,
                Ne: float = 3e4) -> Tree:
    """Build one binary tree (2N-1 nodes) from an asymmetric distance matrix.

    d_cf: optional consistency-prior matrix from the previous tree's clades
    (anc_builder.cpp:583-608).
    """
    N = d.shape[0]
    thr, thr_cf = thresholds(theta)
    key = jax.random.PRNGKey(seed)
    use_cf = d_cf is not None
    use_ages = sample_ages is not None and len(sample_ages) == N and \
        np.any(np.asarray(sample_ages) != 0)

    if use_ages:
        ages = np.sort(np.asarray(sample_ages, dtype=np.float64))
        # heuristic coalescent age grid (tree_builder.cpp:1153-1217)
        uniq, counts = np.unique(ages, return_counts=True)
        grid = np.empty(N - 1, dtype=np.float64)
        level = 0
        num_lins = counts[0]
        age = uniq[0] + 2.0 / (num_lins * max(num_lins - 1.0, 1.0)) * Ne
        # approximate forward simulation of the age bound
        cur = age
        for t in range(N - 1):
            grid[t] = cur
            num_lins = max(num_lins - 1, 1)
            if level + 1 < len(uniq) and num_lins < 2:
                level += 1
                num_lins += counts[level]
            cur += 2.0 / max(num_lins * (num_lins - 1.0), 1.0) * Ne
        ages_dev = jnp.asarray(sample_ages, jnp.float32)
        grid_dev = jnp.asarray(grid, jnp.float32)
    else:
        ages_dev = jnp.zeros(N, jnp.float32)
        grid_dev = jnp.full(N - 1, np.inf, jnp.float32)

    dcf_dev = jnp.asarray(d_cf, jnp.float32) if use_cf \
        else jnp.zeros_like(jnp.asarray(d, jnp.float32))
    cis, cjs = _quick_build_scan(
        jnp.asarray(d, jnp.float32), dcf_dev, key,
        jnp.float32(thr), jnp.float32(thr_cf),
        ages_dev, grid_dev, use_cf, use_ages)
    return tree_from_merges(np.asarray(cis), np.asarray(cjs), N)


def tree_from_merges(cis: np.ndarray, cjs: np.ndarray, N: int) -> Tree:
    """Build the flat tree arrays from merge child lists."""
    M = 2 * N - 1
    parent = np.full(M, -1, dtype=np.int32)
    lab = np.arange(N - 1) + N
    parent[cis] = lab
    parent[cjs] = lab
    cl = np.full(M, -1, dtype=np.int32)
    cr = np.full(M, -1, dtype=np.int32)
    cl[N:] = cis
    cr[N:] = cjs
    return Tree(parent=parent, child_left=cl, child_right=cr)


def clade_prior_matrix(prev_tree: Tree, theta: float) -> np.ndarray:
    """Consistency prior d_CF from the previous tree's internal clades
    (anc_builder.cpp:583-608): for each internal clade C and each member i,
    add val = -log(theta/(1-theta)) to d_CF[i, j] for every j not in C.
    """
    N = prev_tree.N
    val = -float(np.log(theta / (1.0 - theta)))
    leaves = prev_tree.leaf_matrix()          # (2N-1, N)
    d = np.zeros((N, N), dtype=np.float32)
    inner = leaves[N:]                        # internal clades only
    # contribution of clade C: members x non-members += val
    member = inner.astype(np.float32)         # (M, N)
    nonmember = 1.0 - member
    d += val * member.T @ nonmember
    return d


def same_rpos_penalty(d: np.ndarray, carriers_sets, theta: float
                      ) -> np.ndarray:
    """Extra penalty for carriers at SNPs with identical rpos
    (anc_builder.cpp:555-581): for each such SNP's carrier set S, rows of S
    get +val everywhere except toward other members of S.
    """
    val = -float(np.log(theta / (1.0 - theta)))
    N = d.shape[0]
    out = d.copy()
    for S in carriers_sets:
        S = np.asarray(S, dtype=np.int64)
        if len(S) == 0:
            continue
        out[S, :] += val
        out[np.ix_(S, S)] -= val
    return out


def make_fused_rebuild(theta: float, N: int, mode: int,
                       ancestral_state: bool):
    """One-dispatch rebuild kernel: distance assembly (GetMatrix) +
    same-rpos carrier penalty + clade-consistency prior from the previous
    tree's leaf matrix + the MinMatch merge scan, all fused under a single
    jit. Returns fn(topology, logscale, rows, is_exact, wl, wr, kcol,
    carriers, prev_leafmat, key) -> (child_i, child_j) merge lists.
    """
    import jax
    import jax.numpy as jnp
    from .distance import _assemble_ops
    thr, thr_cf = thresholds(theta)
    val = -float(np.log(theta / (1.0 - theta)))
    use_cf = mode == 1

    def fn(topology, logscale, rows, is_exact, wl, wr, kcol, carriers,
           prev_leafmat, key):
        mat = _assemble_ops(topology, logscale, rows, is_exact, wl, wr, kcol)
        if not ancestral_state:
            mat = 0.5 * (mat + mat.T)
        car = carriers.astype(jnp.float32)
        mat = mat + val * car[:, None] * (1.0 - car[None, :])
        if use_cf:
            member = prev_leafmat[N:].astype(jnp.float32)
            dcf = val * (member.T @ (1.0 - member))
        else:
            dcf = jnp.zeros_like(mat)
        return _quick_build_scan(mat, dcf, key, jnp.float32(thr),
                                 jnp.float32(thr_cf),
                                 jnp.zeros(N, jnp.float32),
                                 jnp.full(N - 1, np.inf, jnp.float32),
                                 use_cf, False)

    return jax.jit(fn)


def upgma(d: np.ndarray) -> Tree:
    """UPGMA (average-linkage) tree from a distance matrix
    (MinMatch::UPGMA, include/src/tree_builder.hpp:106 — an unused
    alternative builder kept for API completeness). Works on the
    symmetrized matrix; sequential host implementation."""
    dd = 0.5 * (np.asarray(d, dtype=np.float64)
                + np.asarray(d, dtype=np.float64).T)
    N = dd.shape[0]
    M = 2 * N - 1
    parent = np.full(M, -1, np.int32)
    cl = np.full(M, -1, np.int32)
    cr = np.full(M, -1, np.int32)
    bl = np.zeros(M, np.float64)
    height = np.zeros(M, np.float64)
    size = np.ones(M, np.float64)
    D = np.full((M, M), np.inf)
    D[:N, :N] = dd
    np.fill_diagonal(D, np.inf)
    active = list(range(N))
    for t in range(N - 1):
        sub = D[np.ix_(active, active)]
        k = int(np.argmin(sub))
        ai, aj = divmod(k, len(active))
        i, j = active[ai], active[aj]
        v = N + t
        h = 0.5 * D[i, j]
        parent[i] = parent[j] = v
        cl[v], cr[v] = min(i, j), max(i, j)
        height[v] = h
        bl[i] = h - height[i]
        bl[j] = h - height[j]
        size[v] = size[i] + size[j]
        for x in active:
            if x in (i, j):
                continue
            D[v, x] = D[x, v] = ((size[i] * D[i, x] + size[j] * D[j, x])
                                 / (size[i] + size[j]))
        active = [x for x in active if x not in (i, j)] + [v]
    return Tree(parent=parent, child_left=cl, child_right=cr,
                branch_length=bl)
