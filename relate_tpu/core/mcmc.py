"""Branch-length MCMC under the coalescent — vmapped over trees.

Behavioral reference: ``EstimateBranchLengthsWithSampleAge``
(``include/src/branch_length_estimator.cpp``): Poisson mutation likelihood
per branch (rate ``mut_rate[i] = Ne*mu*sum(dist)`` over the branch's SNP
span, :215-237) times a coalescent prior (constant-Ne :839-898 or
piecewise coalescence rates :1023-1156); proposals are

- ``UpdateOneEvent`` (:1539-1900): move one internal node's age uniformly
  between its older child and parent (exponential proposal at the root);
- ``SwitchOrder`` (:385-583): swap an event with another event of adjacent
  order, exchanging their ages (the sorted coordinate multiset is invariant,
  so the prior cancels).

Mixture 70/30 (:2789), transient ``50*max(N/10,10)`` proposals, then blocks
of ``delta`` proposals until every internal node was proposed >= 50 times and
the running-average ages are monotone along the tree (:2983-3073). Output
branch length = ``Ne * (avg[parent] - avg[node])`` (:3077-3079).

Device design: one chain per tree, all trees of a section advanced in
lockstep by a jitted ``lax.scan`` over proposals under ``vmap`` — thousands
of independent chains are the natural batch axis. Each proposal is O(M)
elementwise work on flat arrays (the reference's O(1)-ish pointer surgery
does not vectorize; O(M) elementwise beats divergent control flow).
Coordinate running means use Kahan compensation (float32-safe for long
chains).

Because a single proposal already costs O(M) dense work per chain, each
scan iteration ALSO runs a **parallel gap sweep** (``make_sweep_fn``): an
age-only Metropolis update proposed simultaneously for every internal node
whose sorted position has a given parity AND whose parent sits at the
opposite parity. That selected set is an independent set in both the tree
(no parent/child pair) and the sorted order (no adjacent positions), and
the proposals keep the event order fixed (each new age is drawn inside the
node's current sorted gap; the root uses the reference's exponential tail
proposal, rejected if it would cross the second-oldest event), so the
posterior factorizes over the selected nodes: the simultaneous local MH
decisions are exact. One sweep delivers ~0.3*(M-N) proposals for ~2x the
cost of a single proposal — the order statistics still mix through the
interleaved UpdateOneEvent/SwitchOrder steps, matching the reference's
kernel support, while age mixing runs ~40x faster per FLOP.

Deliberate deviations from the reference (documented, distribution-level):
- the uniform-int and uniform draws come from JAX threefry streams, not
  mt19937, so chains are not draw-for-draw identical;
- the acceptance ratio of ``UpdateOneEvent`` includes the full affected
  prior window (the reference omits one boundary interval in its no-break
  fast path, branch_length_estimator.cpp:1676-1706);
- ``log(1+t)`` uses log1p instead of the reference's 1e-4-grid lookup table
  (branch_length_estimator.cpp:302-319);
- the initial event order is a uniformly random linear extension of the tree
  poset instead of 2N^2 random switch moves (same support);
- the convergence gate's per-node proposal counter (>=50, matching
  branch_length_estimator.cpp:2983-3073) counts sweep proposals as well as
  singles — per node the gate fills at the same ~50-proposals-per-node
  coverage as the reference, but the proposal MIX per budget is different
  (mostly gap-restricted age moves + adjacent order transpositions + one
  full-range single per iteration). The resulting posterior, including
  ORDER statistics, is differentially tested against the pure single-
  proposal mixture in tests/test_mcmc_sweep.py.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .trees import Tree

P2 = 0.7  # UpdateOneEvent share of proposals

# the group-rate prior's contractions are real-valued: HIGHEST keeps them
# in f32 (a GPU would otherwise round their operands to TF32)
HIGHEST = jax.lax.Precision.HIGHEST

# convergence rounds fused into one device execution between the host's
# convergence checks: the host reads one scalar (all chains converged?)
# every ROUNDS_PER_SPAN rounds
ROUNDS_PER_SPAN = int(os.environ.get("RELATE_TPU_MCMC_ROUNDS_PER_SPAN",
                                     "10"))

# max B*M cells per compiled chain-batch program: bounds device memory and
# program size. To re-derive on the H100 from the MCMC cells (ROADMAP S5).
MAX_CHAIN_CELLS = int(os.environ.get("RELATE_TPU_MCMC_MAX_CELLS",
                                     str(4096 * 511)))


def chain_batch_cap(M: int) -> int:
    cap = max(MAX_CHAIN_CELLS // max(M, 1), 256)
    return 1 << (cap.bit_length() - 1)


class ChainStatic(NamedTuple):
    parent: jnp.ndarray       # (B, M) int32 (-1 at root)
    child_left: jnp.ndarray   # (B, M)
    child_right: jnp.ndarray  # (B, M)
    num_events: jnp.ndarray   # (B, M) f32
    mut_rate: jnp.ndarray     # (B, M) f32
    kc2_pos: jnp.ndarray      # (M,) f32 C(nl(p),2) per sorted position
    # piecewise coalescent prior (constant Ne -> single epoch, rate 1)
    epochs: jnp.ndarray       # (E,) f32 boundaries (epochs[0]=0)
    rates: jnp.ndarray        # (B, E) f32 rate in [epochs[i], epochs[i+1])
    cumR: jnp.ndarray         # (B, E) f32 integral of rate up to boundary
    # pairwise group-rate prior (MCMCCoalRatesForRelate): per-node leaf
    # group fractions and per-epoch G x G rate matrices. The reference's
    # per-node-pair rate (branch_length_estimator.cpp:4052-4070) is exactly
    # the bilinear form f_i^T R_e f_j, so per-level intensities reduce to
    # S^T R S with S the active-lineage fraction sum (O(G^2) per level
    # instead of O(N^2)).
    F: Optional[jnp.ndarray] = None        # (B, M, G) f32 group fractions
    Rg: Optional[jnp.ndarray] = None       # (E, G, G) f32 rates per epoch
    cumIRg: Optional[jnp.ndarray] = None   # (E, G, G) f32 integral to epoch
    depth: Optional[jnp.ndarray] = None    # (B, M) i32 depth below root
    #   (static topology metadata for the gap sweep's independent-set
    #   selection; see make_sweep_fn / tree_depths)


class ChainState(NamedTuple):
    coords: jnp.ndarray       # (B, M) f32 node ages (units of Ne generations)
    order: jnp.ndarray        # (B, M) i32
    sorted_idx: jnp.ndarray   # (B, M) i32
    cs: jnp.ndarray           # (B, M) f32 ages in sorted order — the
    #   invariant cs == coords[sorted_idx] is maintained incrementally so
    #   the hot path never performs a (B, M) permutation gather (see
    #   make_step_fn)
    ssum: jnp.ndarray         # (B, M) f32 Kahan sum of coords
    scomp: jnp.ndarray        # (B, M) f32 Kahan compensation
    count: jnp.ndarray        # (B,) f32
    cprop: jnp.ndarray        # (B, M) i32 proposal counts (internal nodes)


def init_chain_state(coords0, order0, sidx0) -> "ChainState":
    """Build a ChainState from host arrays, establishing the cs invariant."""
    coords0 = np.asarray(coords0, np.float32)
    sidx0 = np.asarray(sidx0, np.int32)
    B, M = coords0.shape
    cs0 = np.take_along_axis(coords0, sidx0, axis=1)
    return ChainState(
        coords=jnp.asarray(coords0),
        order=jnp.asarray(np.asarray(order0, np.int32)),
        sorted_idx=jnp.asarray(sidx0), cs=jnp.asarray(cs0),
        ssum=jnp.zeros((B, M), jnp.float32),
        scomp=jnp.zeros((B, M), jnp.float32),
        count=jnp.zeros((B,), jnp.float32),
        cprop=jnp.zeros((B, M), jnp.int32))


def _log1p(x):
    return jnp.log1p(x)


def _kahan_add(s, c, x):
    y = x - c
    t = s + y
    c2 = (t - s) - y
    return t, c2


def _rate_integral(st: ChainStatic, b, t):
    """Integral of the coalescence rate from 0 to t (piecewise const)."""
    e = jnp.searchsorted(st.epochs, t, side="right") - 1
    e = jnp.clip(e, 0, st.rates.shape[1] - 1)
    return st.cumR[b, e] + st.rates[b, e] * (t - st.epochs[e])


def _rate_at(st: ChainStatic, b, t):
    e = jnp.searchsorted(st.epochs, t, side="right") - 1
    e = jnp.clip(e, 0, st.rates.shape[1] - 1)
    return st.rates[b, e]


def _kc2_from_sorted(sorted_idx, N):
    """Per-position C(num_lineages, 2) from the sorted leaf/internal
    pattern — works for ancient samples (leaves at arbitrary positions).
    For contemporary samples this equals the static 2N-1-p profile."""
    leaf = (sorted_idx < N).astype(jnp.float32)
    nl = jnp.cumsum(leaf) - jnp.cumsum(1.0 - leaf)
    return nl * (nl - 1.0) * 0.5


def _prior_window(st: ChainStatic, b, cs, lo, hi, kc2, leaf_pos):
    """-sum_{p in [lo, hi)} C(nl(p),2) * (R(cs[p+1]) - R(cs[p]))
    + sum of log rate at coalescence endpoints in (lo, hi]."""
    M = cs.shape[0]
    p = jnp.arange(M - 1)
    mask = (p >= lo) & (p < hi)
    Ra = jax.vmap(lambda t: _rate_integral(st, b, t))(cs)
    seg = kc2[:-1] * (Ra[1:] - Ra[:-1])
    out = -jnp.where(mask, seg, 0.0).sum()
    rate_end = jax.vmap(lambda t: _rate_at(st, b, t))(cs[1:])
    logr = jnp.where(mask & ~leaf_pos[1:],
                     jnp.log(jnp.maximum(rate_end, 1e-30)), 0.0).sum()
    return out + logr


def _pair_epoch(st: ChainStatic, t):
    e = jnp.searchsorted(st.epochs, t, side="right") - 1
    return jnp.clip(e, 0, st.Rg.shape[0] - 1)


def _pair_IR(st: ChainStatic, t):
    """(G, G) integral of the per-epoch rate matrices from 0 to t."""
    e = _pair_epoch(st, t)
    return st.cumIRg[e] + st.Rg[e] * (t - st.epochs[e])


def _prior_window_pair(st: ChainStatic, b, N, cs, sidx, lo, hi):
    """Pairwise-group-rate twin of :func:`_prior_window`
    (CalculatePrior with coal_rate_pair, branch_length_estimator.cpp:1159).

    Level p (between sorted events p and p+1) has intensity
    ``0.5*(S_p^T R_e S_p - <D_p, R_e>)`` with S_p the sum and D_p the sum of
    outer products of the active lineages' group-fraction vectors; both are
    cumulative sums along the sorted order (a leaf joins, an internal node
    replaces its two children). The epoch-crossing time integral uses the
    precomputed cumulative-rate matrices. Coalescence events add
    ``log f_cl^T R_e f_cr``.
    """
    F = st.F[b]
    cl = st.child_left[b]
    cr = st.child_right[b]
    fv = F[sidx]                                    # (M, G)
    f1 = F[cl[sidx]]
    f2 = F[cr[sidx]]
    leaf = (sidx < N)[:, None]
    inc = jnp.where(leaf, fv, fv - f1 - f2)
    S = jnp.cumsum(inc, axis=0)                     # (M, G) after event p
    o_v = fv[:, :, None] * fv[:, None, :]
    o_1 = f1[:, :, None] * f1[:, None, :]
    o_2 = f2[:, :, None] * f2[:, None, :]
    Dinc = jnp.where(leaf[:, :, None], o_v, o_v - o_1 - o_2)
    D = jnp.cumsum(Dinc, axis=0)                    # (M, G, G)

    IRa = jax.vmap(lambda t: _pair_IR(st, t))(cs)   # (M, G, G)
    dIR = IRa[1:] - IRa[:-1]
    lam = 0.5 * (jnp.einsum("pg,pgh,ph->p", S[:-1], dIR, S[:-1],
                            precision=HIGHEST)
                 - jnp.einsum("pgh,pgh->p", D[:-1], dIR, precision=HIGHEST))
    M_ = cs.shape[0]
    p = jnp.arange(M_ - 1)
    mask = (p >= lo) & (p < hi)
    out = -jnp.where(mask, lam, 0.0).sum()
    # event terms: coalescences at sorted positions p+1 in (lo, hi]
    ev = sidx[1:]
    Re = st.Rg[jax.vmap(lambda t: _pair_epoch(st, t))(cs[1:])]  # (M-1,G,G)
    rate_ev = jnp.einsum("pg,pgh,ph->p", F[cl[ev]], Re, F[cr[ev]],
                         precision=HIGHEST)
    logr = jnp.where(mask & (ev >= N),
                     jnp.log(jnp.maximum(rate_ev, 1e-30)), 0.0).sum()
    return out + logr


def _rate_integral_bm(st: ChainStatic, t):
    """(B, M)-batched piecewise rate integral R(t) and rate r(t)."""
    e = jnp.clip(jnp.searchsorted(st.epochs, t, side="right") - 1,
                 0, st.rates.shape[1] - 1)
    cum = jnp.take_along_axis(st.cumR, e, axis=1)
    rt = jnp.take_along_axis(st.rates, e, axis=1)
    return cum + rt * (t - st.epochs[e]), rt


def tree_depths_dev(parent):
    """(B, M) device twin of :func:`tree_depths` — fixed
    ceil(log2(M))+1 pointer-doubling rounds of take_along_axis."""
    import jax.numpy as _jnp
    B, M = parent.shape
    d = (parent >= 0).astype(_jnp.int32)
    iota = _jnp.broadcast_to(_jnp.arange(M, dtype=_jnp.int32), (B, M))
    j = _jnp.where(parent >= 0, parent, iota)
    for _ in range(int(np.ceil(np.log2(max(M, 2)))) + 1):
        d = d + _jnp.take_along_axis(d, j, axis=1)
        j = _jnp.take_along_axis(j, j, axis=1)
    return d


def device_init_state(parent_d, N: int, seed: int, depth=None):
    """Initial ChainState built ON DEVICE (contemporary samples).

    The host versions (`_initial_orders_batch` + `_initial_coords_batch` +
    the cs gather) cost seconds per 4096x511 slice on a small host; here
    the initial sorted order is (leaves first, then internal nodes by
    DESCENDING root-depth with random tie-break) — any such order is a
    linear extension (a parent is strictly shallower than its children),
    same support as the host init, and it reuses the depth array the gap
    sweep needs anyway. Initial ages follow the coalescent-prior profile
    per sorted position (InitializeBranchLengths,
    branch_length_estimator.cpp:61-136), exactly as the host twin."""
    B, M = parent_d.shape
    if depth is None:
        depth = tree_depths_dev(parent_d)
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    is_leaf = iota < N
    tie = jax.random.uniform(jax.random.PRNGKey(seed ^ 0x5BF03A7),
                             (B, M), minval=0.0, maxval=0.99)
    keys = jnp.where(is_leaf, -jnp.float32(M + 1) + 0.5,
                     -(depth.astype(jnp.float32)) + tie)
    sidx, = jax.lax.sort_key_val(keys, jnp.broadcast_to(iota, (B, M)))[1:]
    # inverse permutation + position-age profile, both via one sort
    # lineages entering the p-th sorted event: N at the first coalescence,
    # then 2N-p (p = N+1..M-1) — same profile as _initial_coords_batch
    nl_int = np.concatenate([[N], 2 * N - np.arange(N + 1, M)]).astype(
        np.float64)
    cur = np.zeros(M, dtype=np.float64)
    cur[N:] = np.cumsum(2.0 / (nl_int * (nl_int - 1.0)))
    csvals = jnp.broadcast_to(jnp.asarray(cur, jnp.float32)[None, :],
                              (B, M))
    pos = jnp.broadcast_to(iota, (B, M))
    _, order, coords = jax.lax.sort((sidx, pos, csvals), num_keys=1)
    return ChainState(
        coords=coords, order=order, sorted_idx=sidx, cs=csvals,
        ssum=jnp.zeros((B, M), jnp.float32),
        scomp=jnp.zeros((B, M), jnp.float32),
        count=jnp.zeros((B,), jnp.float32),
        cprop=jnp.zeros((B, M), jnp.int32)), depth


def tree_depths(parent: np.ndarray) -> np.ndarray:
    """(B, M) node depths below the root from (B, M) parent arrays
    (pointer doubling: O(log height) gather rounds)."""
    parent = np.asarray(parent)
    d = (parent >= 0).astype(np.int32)
    j = np.maximum(parent, 0).astype(np.int64)
    root_mask = parent < 0
    j[root_mask] = np.broadcast_to(
        np.arange(parent.shape[1]), parent.shape)[root_mask]
    while True:
        d2 = d + np.take_along_axis(d, j, axis=1)
        if np.array_equal(d2, d):
            return d
        d = d2
        j = np.take_along_axis(j, j, axis=1)


def sweep_aux(st: ChainStatic):
    """Loop-invariant sweep inputs, computed once per compiled program:
    child-indexed event counts / mutation rates, and the static scatter
    keys of the family sort (see make_sweep_fn).

    The family sort's key set is a (B, 3M+1) integer array that is a
    permutation of [0, 3M-2N] plus dummies per row: keys [0, M) deliver
    each node's PARENT age (parent i scatters its age to children cl[i],
    cr[i]; the root receives a dummy), keys [M, M+2(M-N)) deliver each
    internal node's two CHILD ages (child c scatters to slot
    M + 2*(parent[c]-N) + is_right_child)."""
    cl = jnp.maximum(st.child_left, 0)
    cr = jnp.maximum(st.child_right, 0)
    ne_cl = jnp.take_along_axis(st.num_events, cl, axis=1)
    ne_cr = jnp.take_along_axis(st.num_events, cr, axis=1)
    mr_cl = jnp.take_along_axis(st.mut_rate, cl, axis=1)
    mr_cr = jnp.take_along_axis(st.mut_rate, cr, axis=1)

    M = st.parent.shape[1]
    N = (M + 1) // 2
    BIG = jnp.int32(4 * M)
    keys_pageL = jnp.where(st.child_left >= 0, st.child_left, BIG)
    keys_pageR = jnp.where(st.child_right >= 0, st.child_right, BIG)
    par_c = jnp.maximum(st.parent, 0)
    node_ids = jnp.arange(M, dtype=jnp.int32)[None, :]
    is_left = jnp.take_along_axis(st.child_left, par_c, axis=1) == node_ids
    side = jnp.where(is_left, 0, 1)
    keys_cage = jnp.where(st.parent >= 0,
                          M + 2 * (par_c - N) + side, BIG)
    root_id = jnp.argmin(st.parent, axis=1, keepdims=True).astype(jnp.int32)
    fc_keys = jnp.concatenate(
        [keys_pageL, keys_pageR, keys_cage, root_id], axis=1)
    return (ne_cl, ne_cr, mr_cl, mr_cr, fc_keys, root_id)


def make_sweep_fn(N: int, M: int, use_vp: bool, use_ages: bool = False):
    """Parallel gap sweep: age-only MH proposals for ALL internal nodes
    whose (tree-depth parity, sorted-position parity) matches the phase
    ``(phase >> 1) & 1, phase & 1`` — each internal node is proposed
    exactly once every 4 phases.

    The selected nodes form an independent set in the tree (equal depth
    parity excludes parent/child pairs) AND in the sorted order (equal
    position parity excludes adjacent positions), and every proposal stays
    inside the node's current sorted gap (cs[p-1], cs[p+1]) — the event
    order, and hence the lineage-count profile, is invariant — so the
    posterior ratio factorizes per node and the simultaneous
    accept/reject decisions are an exact Metropolis kernel (see module
    docstring). Prior delta per node: (kc2[p] - kc2[p-1]) * (R(t') - R(t))
    plus the event-rate term under a piecewise prior; the root keeps the
    exponential tail proposal with its Hastings ratio
    (branch_length_estimator.cpp:1841-1900).

    Data movement: all permutation application runs through THREE stable
    multi-operand ``lax.sort`` calls instead of take_along_axis gathers — a family sort
    (static scatter keys from :func:`sweep_aux`: parent/child ages), a
    position sort (key = sorted_idx: sorted-neighbor ages + lineage
    weights into node order), and an output sort (key = order:
    re-establish the cs invariant)."""

    node_is_internal = (np.arange(M) >= N)[None, :]

    def sweep(st: ChainStatic, s: ChainState, aux, phase, u1, u2,
              active=None, accumulate=True):
        ne_cl, ne_cr, mr_cl, mr_cr, fc_keys, root_id = aux
        coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
        parent = st.parent
        is_root = parent < 0
        pos = order
        dpar = (phase >> 1) & 1
        ppar = phase & 1
        sel = (node_is_internal & ((st.depth & 1) == dpar)
               & ((pos & 1) == ppar))

        # family sort: parent age and the two child ages, node-indexed
        rootval = jnp.take_along_axis(coords, root_id, axis=1)
        fc_vals = jnp.concatenate([coords, coords, coords, rootval], axis=1)
        _, fc_sorted = jax.lax.sort((fc_keys, fc_vals), num_keys=1)
        page = fc_sorted[:, :M]
        cage = fc_sorted[:, M: M + 2 * (M - N)].reshape(-1, M - N, 2)
        zl = jnp.zeros_like(cage[:, :1, 0], shape=cage.shape[:1] + (N,))
        cage_l = jnp.concatenate([zl, cage[:, :, 0]], axis=1)
        cage_r = jnp.concatenate([zl, cage[:, :, 1]], axis=1)
        cmax = jnp.maximum(cage_l, cage_r)

        # position sort: sorted-neighbor ages + lineage weights to nodes
        cs_m1 = jnp.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        cs_p1 = jnp.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        if use_ages:
            leaf_sorted = (sidx < N).astype(jnp.float32)
            nlv = (jnp.cumsum(leaf_sorted, axis=1)
                   - jnp.cumsum(1.0 - leaf_sorted, axis=1))
            kc2c = nlv * (nlv - 1.0) * 0.5
        else:
            kc2c = jnp.broadcast_to(st.kc2_pos[None, :], cs.shape)
        kc2m = jnp.concatenate([kc2c[:, :1], kc2c[:, :-1]], axis=1)
        _, cs_lo, cs_hi, kc2_p, kc2_pm1 = jax.lax.sort(
            (sidx, cs_m1, cs_p1, kc2c, kc2m), num_keys=1)

        t = coords
        # non-root: symmetric uniform draw inside the sorted gap
        tnew_nr = cs_lo + u1 * (cs_hi - cs_lo)
        # root: exponential tail proposal + Hastings ratio
        tau_old = t - cmax
        posr = tau_old > 0
        lu = -jnp.log(jnp.maximum(u1, 1e-30))
        tau_new = jnp.where(posr, lu * tau_old, lu)
        safe_old = jnp.maximum(tau_old, 1e-30)
        safe_new = jnp.maximum(tau_new, 1e-30)
        hast_r = jnp.where(
            posr,
            jnp.log(safe_old / safe_new) + (tau_new / safe_old
                                            - tau_old / safe_new),
            jnp.log(1.0 / safe_new) + tau_new)
        tnew = jnp.where(is_root, cmax + tau_new, tnew_nr)
        delta = tnew - t

        w = jnp.where(is_root, -kc2_pm1, kc2_p - kc2_pm1)
        if use_vp:
            Rt, rt = _rate_integral_bm(st, t)
            Rt2, rt2 = _rate_integral_bm(st, tnew)
            pr = (w * (Rt2 - Rt)
                  + jnp.log(jnp.maximum(rt2, 1e-30))
                  - jnp.log(jnp.maximum(rt, 1e-30)))
        else:
            pr = w * delta

        tb = page - t
        tbl = t - cage_l
        tbr = t - cage_r
        coeff = jnp.where(is_root, -(mr_cl + mr_cr),
                          st.mut_rate - mr_cl - mr_cr)
        mut = coeff * delta
        mut = mut + jnp.where((~is_root) & (st.num_events >= 1.0),
                              st.num_events * _log1p(-delta / tb), 0.0)
        mut = mut + jnp.where(ne_cl >= 1.0, ne_cl * _log1p(delta / tbl),
                              0.0)
        mut = mut + jnp.where(ne_cr >= 1.0, ne_cr * _log1p(delta / tbr),
                              0.0)

        llr = pr + mut + jnp.where(is_root, hast_r, 0.0)
        bad_inf = (tbl == 0.0) | (tbr == 0.0) | (~is_root & (tb == 0.0))
        bad_rej = ((tbl <= -delta) | (tbr <= -delta)
                   | (~is_root & (tb <= delta)))
        # the root move must not cross the second-oldest event (the sweep
        # is order-preserving by construction)
        bad_rej = bad_rej | (is_root & (tnew <= cs[:, M - 2][:, None]))
        llr = jnp.where(bad_inf, jnp.inf, llr)
        llr = jnp.where(bad_rej, -jnp.inf, llr)
        acc = sel & (jnp.log(u2) < llr)
        if active is not None:
            acc = acc & active[:, None]

        coords2 = jnp.where(acc, tnew, coords)
        # output sort: re-establish the cs == coords[sorted_idx] invariant
        _, cs2 = jax.lax.sort((order, coords2), num_keys=1)
        if accumulate:
            ssum, scomp = _kahan_add(s.ssum, s.scomp, coords2)
            # gap-sweep proposals count toward the per-node cprop gate
            # (the gate measures proposal COVERAGE per node, as in the
            # reference; ORDER mixing is guarded separately by the
            # differential order-statistics test, tests/test_mcmc_sweep.py
            # — see the module docstring's deviations)
            dprop = sel.astype(jnp.int32)
            if active is not None:
                ssum = jnp.where(active[:, None], ssum, s.ssum)
                scomp = jnp.where(active[:, None], scomp, s.scomp)
                count = s.count + active.astype(jnp.float32)
                dprop = jnp.where(active[:, None], dprop, 0)
            else:
                count = s.count + 1.0
            cprop = s.cprop + dprop
        else:
            ssum, scomp, count, cprop = s.ssum, s.scomp, s.count, s.cprop
        return ChainState(coords2, order, sidx, cs2, ssum, scomp, count,
                          cprop)

    return sweep



def make_order_sweep_fn(N: int, M: int):
    """Parallel adjacent-transposition ORDER sweep: for every sorted
    position pair (p, p+1) with p = phase (mod 8), propose exchanging the
    AGES of the two events (equivalently, swapping their order) — the
    device-parallel counterpart of the reference's ``SwitchOrder``
    (branch_length_estimator.cpp:385-583), restricted to adjacent events.

    The selection stride is 8 (not 4): with stride-4 pairs, HALF of all
    positions are swap slots, so the family-invalidation predicate below
    kills ~98% of pairs (measured); at stride 8 only a quarter of
    positions are slots and ~10x more pairs survive — more REAL order
    moves per sweep despite fewer candidate pairs.

    Exactness of the simultaneous decisions:

    - the sorted age multiset and the per-position lineage profile are
      invariant under every swap, so the coalescent prior (constant, vp,
      and ancient-sample variants) cancels exactly — only the per-branch
      Poisson mutation terms enter the ratio, as in the reference;
    - two nodes at ADJACENT sorted positions can only be poset-related as
      direct parent/child (any longer chain would need a node strictly
      between their positions), so ``parent[u] == v`` is the complete
      order-validity check;
    - a pair's ratio involves the ages of the pair's nodes and their
      parents/children only; a pair is invalidated when any such family
      member is internal AND sits at a position of class
      ``(r - phase) mod 8 in {0, 1}`` (i.e. could itself be swapped this
      phase). Position classes are invariant under the swaps (a swap moves
      nodes between p and p+1, both in-class), and leaves never swap, so
      the selection predicate is measurable with respect to the frozen
      complement and the joint kernel factorizes per pair;
    - this also covers the within-pair relation: ``parent[u] == v`` puts
      an internal family member at p+1 (in class), invalidating the pair.

    Data movement mirrors make_sweep_fn: three stable multi-operand
    ``lax.sort`` calls (family scatter, node->position, position->node)
    instead of gathers."""

    node_is_internal = (np.arange(M) >= N)[None, :]
    pos_iota = jnp.arange(M, dtype=jnp.int32)[None, :]

    def sweep(st: ChainStatic, s: ChainState, aux, phase, u2,
              active=None, accumulate=True):
        ne_cl, ne_cr, mr_cl, mr_cr, fc_keys, root_id = aux
        coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
        B = coords.shape[0]
        is_root = st.parent < 0

        # family sort #1: parent/child AGES and POSITIONS into node order
        rootval = jnp.take_along_axis(coords, root_id, axis=1)
        rootord = jnp.take_along_axis(order, root_id, axis=1)
        fc_age = jnp.concatenate([coords, coords, coords, rootval], axis=1)
        fc_ord = jnp.concatenate([order, order, order, rootord], axis=1)
        _, fage, ford = jax.lax.sort((fc_keys, fc_age, fc_ord), num_keys=1)
        page = fage[:, :M]
        page_ord = ford[:, :M]
        cage = fage[:, M: M + 2 * (M - N)].reshape(B, M - N, 2)
        cord = ford[:, M: M + 2 * (M - N)].reshape(B, M - N, 2)
        zf = jnp.zeros((B, N), fage.dtype)
        zi = jnp.zeros((B, N), ford.dtype)
        cage_l = jnp.concatenate([zf, cage[:, :, 0]], axis=1)
        cage_r = jnp.concatenate([zf, cage[:, :, 1]], axis=1)
        cord_l = jnp.concatenate([zi, cord[:, :, 0]], axis=1)
        cord_r = jnp.concatenate([zi, cord[:, :, 1]], axis=1)

        # position-neighbor ages into node order (sort #2a, shared keys)
        cs_m1 = jnp.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        cs_p1 = jnp.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        _, cs_lo, cs_hi = jax.lax.sort((sidx, cs_m1, cs_p1), num_keys=1)

        # node-major: mutation llr of moving to the age one position up
        # (m_up) / down (m_dn); family bounds as in the age sweep
        def mut_delta(delta):
            tb = page - coords
            tbl = coords - cage_l
            tbr = coords - cage_r
            coeff = jnp.where(is_root, -(mr_cl + mr_cr),
                              st.mut_rate - mr_cl - mr_cr)
            m = coeff * delta
            m = m + jnp.where((~is_root) & (st.num_events >= 1.0),
                              st.num_events * _log1p(-delta / tb), 0.0)
            m = m + jnp.where(ne_cl >= 1.0, ne_cl * _log1p(delta / tbl),
                              0.0)
            m = m + jnp.where(ne_cr >= 1.0, ne_cr * _log1p(delta / tbr),
                              0.0)
            bad_inf = (tbl == 0.0) | (tbr == 0.0) | (~is_root & (tb == 0.0))
            bad_rej = ((tbl <= -delta) | (tbr <= -delta)
                       | (~is_root & (tb <= delta)))
            m = jnp.where(bad_inf, jnp.inf, m)
            m = jnp.where(bad_rej, -jnp.inf, m)
            return m

        m_up = mut_delta(cs_hi - coords)
        m_dn = mut_delta(cs_lo - coords)

        # family invalidation: internal member at an in-class position
        def touched(r):
            return ((r - phase) & 7) < 2

        fam_ok = ~(touched(page_ord) & ~is_root)
        fam_ok &= ~((st.child_left >= N) & touched(cord_l))
        fam_ok &= ~((st.child_right >= N) & touched(cord_r))
        fam_ok &= node_is_internal
        # pack (fam_ok, m_up, m_dn) into position order (sort #2b)
        _, fam_ok_p, m_up_p, m_dn_p = jax.lax.sort(
            (order, fam_ok.astype(jnp.float32), m_up, m_dn), num_keys=1)

        # position-major pair decisions: pair (p, p+1), p = phase (mod 4)
        fam_ok_n = jnp.concatenate(
            [fam_ok_p[:, 1:], jnp.zeros((B, 1), jnp.float32)], axis=1)
        m_dn_n = jnp.concatenate(
            [m_dn_p[:, 1:], jnp.full((B, 1), -jnp.inf)], axis=1)
        sel = ((pos_iota & 7) == phase) & (pos_iota < M - 2)
        valid = sel & (fam_ok_p > 0.5) & (fam_ok_n > 0.5)
        llr = m_up_p + m_dn_n
        acc = valid & (jnp.log(u2) < llr)
        if active is not None:
            acc = acc & active[:, None]
            valid = valid & active[:, None]
        acc_prev = jnp.concatenate(
            [jnp.zeros((B, 1), bool), acc[:, :-1]], axis=1)

        sidx_up = jnp.concatenate([sidx[:, 1:], sidx[:, -1:]], axis=1)
        sidx_dn = jnp.concatenate([sidx[:, :1], sidx[:, :-1]], axis=1)
        new_sidx = jnp.where(acc, sidx_up,
                             jnp.where(acc_prev, sidx_dn, sidx))

        # output sort (sort #3): node-major new order and new coords in one
        # pass — sorting positions and position-ages by the new occupant
        _, new_order, new_coords = jax.lax.sort(
            (new_sidx, jnp.broadcast_to(pos_iota, (B, M)), cs), num_keys=1)

        # per-node order-proposal counts: members of valid pairs
        valid_prev = jnp.concatenate(
            [jnp.zeros((B, 1), bool), valid[:, :-1]], axis=1)
        prop_pos = (valid | valid_prev).astype(jnp.float32)
        _, dprop_f = jax.lax.sort((new_sidx, prop_pos), num_keys=1)

        if accumulate:
            ssum, scomp = _kahan_add(s.ssum, s.scomp, new_coords)
            if active is not None:
                ssum = jnp.where(active[:, None], ssum, s.ssum)
                scomp = jnp.where(active[:, None], scomp, s.scomp)
                count = s.count + active.astype(jnp.float32)
            else:
                count = s.count + 1.0
            cprop = s.cprop + dprop_f.astype(jnp.int32)
        else:
            ssum, scomp, count, cprop = (s.ssum, s.scomp, s.count,
                                         s.cprop)
        return ChainState(new_coords, new_order, new_sidx, cs, ssum, scomp,
                          count, cprop)

    return sweep


def make_step_fn(N: int, M: int, use_vp: bool, use_pair: bool = False,
                 use_ages: bool = False):
    """One MCMC proposal, vmapped over the tree batch.

    Hot-path structure (the step runs ~10^4 times per tree batch, so every
    per-step op counts): the proposal type is ONE global coin per step
    (``lax.cond`` — only the chosen branch executes; the chains remain a
    valid 70/30 kernel mixture, the coin just stops being independent
    across trees), uniforms are drawn batched instead of per-tree key
    splits, all single-element updates are ``where`` forms (elementwise,
    fusable) instead of scatters, and the sorted-order update is a
    shift-gather instead of an inverse-permutation scatter. With
    contemporary samples (``use_ages=False``) the per-position lineage
    profile is the static ``kc2_pos`` (leaves always occupy the first N
    sorted positions), skipping two cumsums per proposal."""

    def update_one_event(st: ChainStatic, s: ChainState, b, node_k, u1, u2):
        parent = st.parent[b]
        cl = st.child_left[b]
        cr = st.child_right[b]
        ne = st.num_events[b]
        mr = st.mut_rate[b]
        coords = s.coords[b]
        order = s.order[b]
        sidx = s.sorted_idx[b]
        cs = s.cs[b]

        is_root = node_k == M - 1
        par = parent[node_k]
        c1 = cl[node_k]
        c2 = cr[node_k]
        # pack the per-node scalar reads into a handful of tiny gathers
        # (vmap batches each indexed read into its own gather op; packed
        # (B, 4) gathers keep the op count low)
        idx4 = jnp.stack([node_k, par, c1, c2])
        co4 = coords[idx4]
        or4 = order[idx4]
        ne4 = ne[idx4]
        mr4 = mr[idx4]

        # --- root branch ---------------------------------------------
        cmax = jnp.maximum(co4[2], co4[3])
        tau_old_r = co4[0] - cmax
        pos_r = tau_old_r > 0
        tau_new_r = jnp.where(pos_r, -jnp.log(u1) * tau_old_r, -jnp.log(u1))
        delta_r = jnp.where(pos_r, tau_new_r - tau_old_r, tau_new_r)
        llr_r = jnp.where(
            pos_r,
            jnp.log(tau_old_r / tau_new_r)
            + (tau_new_r / tau_old_r - tau_old_r / tau_new_r),
            jnp.log(1.0 / jnp.maximum(tau_new_r, 1e-30)) + tau_new_r)
        if use_pair:
            # top level holds only the root's two children; its intensity is
            # their pair rate f_c1^T R f_c2 (branch_length_estimator.cpp:613)
            fc1 = st.F[b][c1]
            fc2 = st.F[b][c2]
            rootc = co4[0]
            def bi(Mx):
                return jnp.dot(jnp.dot(fc1, Mx, precision=HIGHEST), fc2,
                               precision=HIGHEST)
            llr_r = llr_r + (
                -(bi(_pair_IR(st, rootc + delta_r)) - bi(_pair_IR(st, cmax)))
                + jnp.log(jnp.maximum(
                    bi(st.Rg[_pair_epoch(st, rootc + delta_r)]), 1e-30))
                + (bi(_pair_IR(st, rootc)) - bi(_pair_IR(st, cmax)))
                - jnp.log(jnp.maximum(
                    bi(st.Rg[_pair_epoch(st, rootc)]), 1e-30)))
        elif use_vp:
            rootc = co4[0]
            llr_r = llr_r + (
                -(_rate_integral(st, b, rootc + delta_r)
                  - _rate_integral(st, b, cmax))
                + jnp.log(jnp.maximum(_rate_at(st, b, rootc + delta_r),
                                      1e-30))
                + (_rate_integral(st, b, rootc)
                   - _rate_integral(st, b, cmax))
                - jnp.log(jnp.maximum(_rate_at(st, b, rootc), 1e-30)))
        else:
            llr_r = llr_r - delta_r
        # mutation terms (children only)
        tbl = co4[0] - co4[2]
        tbr = co4[0] - co4[3]
        mut_r = (-mr4[2] - mr4[3]) * delta_r
        mut_r = mut_r + jnp.where(ne4[2] >= 1.0,
                                  ne4[2] * _log1p(delta_r / tbl), 0.0)
        mut_r = mut_r + jnp.where(ne4[3] >= 1.0,
                                  ne4[3] * _log1p(delta_r / tbr), 0.0)
        llr_r = llr_r + mut_r
        llr_r = jnp.where((tbl == 0.0) | (tbr == 0.0), jnp.inf, llr_r)
        llr_r = jnp.where((tbl <= -delta_r) | (tbr <= -delta_r),
                          -jnp.inf, llr_r)
        acc_r = jnp.log(u2) < llr_r
        nodes = jnp.arange(M)
        pos = nodes
        coords_root = coords + jnp.where(
            (nodes == node_k) & acc_r, delta_r, 0.0)
        # the root always occupies the last sorted position (it is the
        # oldest event: every node's ancestor chain ends at it)
        cs_root = cs + jnp.where((pos == M - 1) & acc_r, delta_r, 0.0)

        # --- internal branch -----------------------------------------
        tb = co4[1] - co4[0]
        tau_below = jnp.minimum(tbl, tbr)
        T = tau_below + tb
        tau_new_below = u1 * T
        delta = tau_new_below - tau_below
        cnew = co4[0] + delta
        k = or4[0]
        kp = or4[1]
        kc = jnp.maximum(or4[2], or4[3])

        up_cnt = ((pos > k) & (pos < kp) & (cs < cnew)).sum()
        dn_cnt = ((pos < k) & (pos > kc) & (cs > cnew)).sum()
        k_new = k + up_cnt - dn_cnt

        o = order
        newo = jnp.where((o > k) & (o <= k_new), o - 1,
                         jnp.where((o < k) & (o >= k_new), o + 1, o))
        newo = jnp.where(nodes == node_k, k_new, newo)
        # moving position k to k_new shifts the subrange between them by
        # one: pure roll+select forms (rolls lower to slices — no
        # permutation gather ever touches the hot path)
        up_region = (k_new > k) & (pos >= k) & (pos < k_new)
        dn_region = (k_new < k) & (pos > k_new) & (pos <= k)
        sidx_up = jnp.roll(sidx, -1)
        sidx_dn = jnp.roll(sidx, 1)
        sorted_new = jnp.where(
            pos == k_new, node_k,
            jnp.where(up_region, sidx_up,
                      jnp.where(dn_region, sidx_dn, sidx))).astype(jnp.int32)
        cs_up = jnp.roll(cs, -1)
        cs_dn = jnp.roll(cs, 1)
        cs_new = jnp.where(
            pos == k_new, cnew,
            jnp.where(up_region, cs_up, jnp.where(dn_region, cs_dn, cs)))
        coords_new = jnp.where(nodes == node_k, cnew, coords)

        lo = jnp.maximum(jnp.minimum(k, k_new) - 1, 0)
        hi = jnp.minimum(jnp.maximum(k, k_new) + 1, M - 1)
        if use_ages:
            kc2_old = _kc2_from_sorted(sidx, N)
            kc2_new = _kc2_from_sorted(sorted_new, N)
        else:
            # contemporary samples: leaves always occupy the first N sorted
            # positions, so the lineage profile is position-static
            kc2_old = kc2_new = st.kc2_pos
        if use_pair:
            pr_new = _prior_window_pair(st, b, N, cs_new, sorted_new, lo, hi)
            pr_old = _prior_window_pair(st, b, N, cs, sidx, lo, hi)
        elif use_vp:
            if use_ages:
                leaf_old = sidx < N
                leaf_new = sorted_new < N
            else:
                leaf_old = leaf_new = pos < N
            pr_new = _prior_window(st, b, cs_new, lo, hi, kc2_new, leaf_new)
            pr_old = _prior_window(st, b, cs, lo, hi, kc2_old, leaf_old)
        else:
            p = jnp.arange(M - 1)
            mask = (p >= lo) & (p < hi)
            pr_new = -jnp.where(mask, kc2_new[:-1]
                                * (cs_new[1:] - cs_new[:-1]), 0.0).sum()
            pr_old = -jnp.where(mask, kc2_old[:-1]
                                * (cs[1:] - cs[:-1]), 0.0).sum()
        llr = pr_new - pr_old
        mut = (mr4[0] - mr4[2] - mr4[3]) * delta
        mut = mut + jnp.where(ne4[0] >= 1.0,
                              ne4[0] * _log1p(-delta / tb), 0.0)
        mut = mut + jnp.where(ne4[2] >= 1.0,
                              ne4[2] * _log1p(delta / tbl), 0.0)
        mut = mut + jnp.where(ne4[3] >= 1.0,
                              ne4[3] * _log1p(delta / tbr), 0.0)
        llr = llr + mut
        llr = jnp.where((tb == 0.0) | (tbl == 0.0) | (tbr == 0.0),
                        jnp.inf, llr)
        llr = jnp.where((tb <= delta) | (tbl <= -delta) | (tbr <= -delta),
                        -jnp.inf, llr)
        valid = (tau_below >= 0) & (tb >= 0)
        acc = valid & (jnp.log(u2) < llr)

        coords_i = jnp.where(acc, coords_new, coords)
        order_i = jnp.where(acc, newo, order)
        sorted_i = jnp.where(acc, sorted_new, sidx)
        cs_i = jnp.where(acc, cs_new, cs)

        coords_out = jnp.where(is_root, coords_root, coords_i)
        order_out = jnp.where(is_root, order, order_i)
        sorted_out = jnp.where(is_root, sidx, sorted_i)
        cs_out = jnp.where(is_root, cs_root, cs_i)
        return coords_out, order_out, sorted_out, cs_out

    def switch_order(st: ChainStatic, s: ChainState, b, node_k, u1, u2):
        parent = st.parent[b]
        cl = st.child_left[b]
        cr = st.child_right[b]
        ne = st.num_events[b]
        mr = st.mut_rate[b]
        coords = s.coords[b]
        order = s.order[b]
        sidx = s.sorted_idx[b]
        cs = s.cs[b]

        fam_k = jnp.stack([node_k, parent[node_k], cl[node_k], cr[node_k]])
        ork = order[fam_k]
        k = ork[0]
        par_o = ork[1]
        ch_o = jnp.maximum(ork[2], ork[3])
        gap = par_o - ch_o
        span = jnp.maximum(gap - 1, 1)
        new_order = ch_o + 1 + jnp.minimum(
            (u1 * span).astype(jnp.int32), span - 1)
        node_swap = sidx[new_order]
        valid = (gap > 2) & (node_swap >= N)
        fam_s = jnp.stack([node_swap, parent[node_swap], cl[node_swap],
                           cr[node_swap]])
        ors = order[fam_s]
        valid &= (jnp.maximum(ors[2], ors[3]) < k) & (k < ors[1])

        # all eight node ages / rates / event counts in one packed gather
        idx8 = jnp.concatenate([fam_k, fam_s])
        co8 = coords[idx8]
        ne8 = ne[idx8]
        mr8 = mr[idx8]
        delta = co8[4] - co8[0]

        def mut_terms(o, dlt):
            tb = co8[o + 1] - co8[o]
            tbl = co8[o] - co8[o + 2]
            tbr = co8[o] - co8[o + 3]
            m = (mr8[o] - mr8[o + 2] - mr8[o + 3]) * dlt
            m = m + jnp.where(ne8[o] >= 0.0,
                              ne8[o] * _log1p(-dlt / tb), 0.0)
            m = m + jnp.where(ne8[o + 3] >= 0.0,
                              ne8[o + 3] * _log1p(dlt / tbr), 0.0)
            m = m + jnp.where(ne8[o + 2] >= 0.0,
                              ne8[o + 2] * _log1p(dlt / tbl), 0.0)
            bad_inf = (tb == 0.0) | (tbl == 0.0) | (tbr == 0.0)
            bad_rej = (tb <= dlt) | (tbl <= -dlt) | (tbr <= -dlt)
            return m, bad_inf, bad_rej

        m1, inf1, rej1 = mut_terms(0, delta)
        m2, inf2, rej2 = mut_terms(4, -delta)
        llr = m1 + m2
        llr = jnp.where(inf1 | inf2, jnp.inf, llr)
        llr = jnp.where(rej1 | rej2, -jnp.inf, llr)
        acc = valid & (jnp.log(u2) < llr) & (new_order != k)

        ck = co8[0]
        csw = co8[4]
        nodes = jnp.arange(M)
        is_k = nodes == node_k
        is_sw = nodes == node_swap
        coords2 = jnp.where(acc & is_k, csw,
                            jnp.where(acc & is_sw, ck, coords))
        order2 = jnp.where(acc & is_k, new_order,
                           jnp.where(acc & is_sw, k, order))
        at_k = nodes == k
        at_new = nodes == new_order
        sidx2 = jnp.where(acc & at_k, node_swap,
                          jnp.where(acc & at_new, node_k, sidx))
        # the two events exchange ages, so the sorted age multiset — and
        # hence cs — is invariant under SwitchOrder
        return coords2, order2, sidx2.astype(jnp.int32), cs

    def step(st: ChainStatic, s: ChainState, key, accumulate: bool,
             active=None):
        """One proposal per tree; ``active`` (B,) bool, when given, freezes
        retired chains (their state and running sums stop updating — the
        device-side equivalent of the reference converging each tree
        independently, branch_length_estimator.cpp:2983-3073)."""
        B = s.coords.shape[0]
        k_coin, k_node, k_u1, k_u2 = jax.random.split(key, 4)
        un = jax.random.uniform(k_node, (B,))
        u1s = jax.random.uniform(k_u1, (B,))
        u2s = jax.random.uniform(k_u2, (B,))
        bs = jnp.arange(B)

        def ue_all(_):
            node = N + jnp.minimum((un * (M - N)).astype(jnp.int32),
                                   M - N - 1)
            c, o, si, csn = jax.vmap(update_one_event,
                                     in_axes=(None, None, 0, 0, 0, 0))(
                st, s, bs, node, u1s, u2s)
            dprop = (jnp.arange(M)[None, :]
                     == node[:, None]).astype(jnp.int32)
            return c, o, si, csn, dprop

        def so_all(_):
            node = N + jnp.minimum((un * (M - N - 1)).astype(jnp.int32),
                                   M - N - 2)
            c, o, si, csn = jax.vmap(switch_order,
                                     in_axes=(None, None, 0, 0, 0, 0))(
                st, s, bs, node, u1s, u2s)
            return c, o, si, csn, jnp.zeros((B, M), jnp.int32)

        if use_pair:
            # the reference's pairwise-rate chain proposes UpdateOneEventVP
            # only (p2 = 1.0, branch_length_estimator.cpp:4075) — SwitchOrder
            # would not cancel in the prior when rates depend on which pair
            # coalesces
            coords, order, sidx, cs, dprop = ue_all(None)
        else:
            # one global coin per step: only the chosen proposal type is
            # computed (the 70/30 mixture need not be independent across
            # the independent chains)
            do_ue = jax.random.uniform(k_coin) <= P2
            coords, order, sidx, cs, dprop = jax.lax.cond(do_ue, ue_all,
                                                          so_all, None)
        if active is not None:
            m = active[:, None]
            coords = jnp.where(m, coords, s.coords)
            order = jnp.where(m, order, s.order)
            sidx = jnp.where(m, sidx, s.sorted_idx)
            cs = jnp.where(m, cs, s.cs)
            dprop = jnp.where(m, dprop, 0)
        if accumulate:
            ssum, scomp = _kahan_add(s.ssum, s.scomp, coords)
            if active is not None:
                ssum = jnp.where(active[:, None], ssum, s.ssum)
                scomp = jnp.where(active[:, None], scomp, s.scomp)
                count = s.count + active.astype(jnp.float32)
            else:
                count = s.count + 1.0
            cprop = s.cprop + dprop
        else:
            ssum, scomp, count, cprop = s.ssum, s.scomp, s.count, s.cprop
        return ChainState(coords, order, sidx, cs, ssum, scomp, count,
                          cprop)

    return step


class _Block:
    """Compiled fixed-length proposal blocks + device-side convergence
    check (one scalar per tree crosses the host link per round)."""

    def __init__(self, N, M, use_vp, use_pair=False, use_ages=False,
                 sweeps="both"):
        """``sweeps``: "both" (default), "age", "order", or "none" —
        which parallel sweeps each iteration runs besides the single
        proposal. Non-default values exist for the differential sweep
        tests (tests/test_mcmc_sweep.py)."""
        self._step = make_step_fn(N, M, use_vp, use_pair, use_ages)
        # the pairwise-group prior couples levels through which pair
        # coalesces; the gap sweep's per-node factorization still holds
        # (order fixed -> S/D profiles fixed) but is not implemented for
        # it — pair chains run single proposals only
        self._use_sweeps = not use_pair and sweeps != "none"
        self._sweep = (make_sweep_fn(N, M, use_vp, use_ages)
                       if self._use_sweeps and sweeps in ("both", "age")
                       else None)
        self._osweep = (make_order_sweep_fn(N, M)
                        if self._use_sweeps and sweeps in ("both", "order")
                        else None)
        # nominal proposals per scan iteration, used to convert the
        # reference's proposal budgets (transient, convergence blocks,
        # sampling gaps) into iteration counts: 1 single proposal + the
        # age gap sweep's ~(M-N)/4 selected nodes (+ the order sweep's
        # ~(M-N)/8 pair slots when enabled). The cprop gate counts the
        # same per-node proposals, so gate coverage per node matches the
        # reference's >=50 criterion at the converted budgets; ORDER
        # mixing per budget is thinner than the reference's (adjacent
        # transpositions + 1 full-range single per iteration) — guarded
        # empirically by tests/test_mcmc_sweep.py's order-statistics
        # differential, not by the budget conversion.
        self.ppi = 1.0
        if self._sweep is not None:
            self.ppi += 0.5 * (M - N)      # two phases per iteration
        if self._osweep is not None:
            self.ppi += 0.125 * (M - N)

        def iteration(st, aux, s, key, i, accumulate, active=None):
            s = self._step(st, s, jax.random.fold_in(key, 3 * i),
                           accumulate, active)
            if self._sweep is not None:
                # two age-sweep phases per iteration — same depth parity,
                # both position parities — so EVERY internal node of that
                # depth parity gets one age proposal per iteration
                # (0.5/node/iter): the >=50-per-node gate fills in ~100
                # iterations for ~1.35x the per-iteration cost
                kk = jax.random.fold_in(key, 3 * i + 1)
                for s_i, ph in enumerate((i % 4, (i % 4) ^ 1)):
                    ku1, ku2 = jax.random.split(
                        jax.random.fold_in(kk, s_i))
                    u1 = jax.random.uniform(ku1, s.coords.shape)
                    u2 = jax.random.uniform(ku2, s.coords.shape)
                    s = self._sweep(st, s, aux, ph, u1, u2, active,
                                    accumulate)
            if self._osweep is not None:
                ko = jax.random.fold_in(key, 3 * i + 2)
                uo = jax.random.uniform(ko, s.coords.shape)
                s = self._osweep(st, s, aux, i % 8, uo, active,
                                 accumulate)
            return s
        self._iteration = iteration

        def run(st, s, key, nsteps, accumulate):
            aux = sweep_aux(st) if self._use_sweeps else None

            def body(s, i):
                return iteration(st, aux, s, key, i, accumulate), None
            s, _ = jax.lax.scan(body, s, jnp.arange(nsteps))
            return s
        self.run = jax.jit(run, static_argnames=("nsteps", "accumulate"))

        def converged(st, s):
            # per-tree: every internal node proposed >= 50 times AND the
            # running-average ages are monotone along the tree
            count_ok = s.cprop[:, N:].min(axis=1) >= 50
            avg = s.ssum / jnp.maximum(s.count[:, None], 1.0)
            par = jnp.maximum(st.parent, 0)
            pav = jnp.take_along_axis(avg, par, axis=1)
            node_ok = (avg <= pav + 1e-7) | (st.parent < 0)
            mono = node_ok[:, N:].all(axis=1)
            return count_ok & mono
        self.converged = jax.jit(converged)

        def run_rounds(st, s, key, conv, rnd0, rounds_cap, block_steps):
            """A bounded span of convergence rounds as one device program:
            ``lax.while_loop`` until every tree converged or ``rounds_cap``
            (a traced scalar — no recompile per span) is reached, with
            converged chains frozen by the step mask. The adaptive loop
            (branch_length_estimator.cpp:2947-3073) is split into spans;
            the host loop in :func:`run_mcmc` chains spans with only a
            scalar `all(conv)` download between them."""
            def cond(c):
                _, rnd, conv = c
                return (rnd < rounds_cap) & ~conv.all()

            aux = sweep_aux(st) if self._use_sweeps else None

            def body(c):
                s, rnd, conv = c
                kb = jax.random.fold_in(key, 1_000_000 + rnd)
                active = ~conv

                def bbody(s, i):
                    return iteration(st, aux, s, kb, i, True, active), None
                s, _ = jax.lax.scan(bbody, s, jnp.arange(block_steps))
                return (s, rnd + 1, conv | converged(st, s))

            return jax.lax.while_loop(cond, body, (s, rnd0, conv))
        self.run_rounds = jax.jit(run_rounds,
                                  static_argnames=("block_steps",))

        def run_to_convergence(st, s, key, transient_steps, block_steps,
                               max_rounds, rounds_per_span=None):
            """Transient + per-tree convergence loop (host-chained spans).

            ``transient_steps``/``block_steps`` are PROPOSAL budgets in the
            reference's units; they are converted to scan iterations via
            ``self.ppi`` (each iteration = 1 single proposal + 1 gap
            sweep)."""
            if rounds_per_span is None:
                rounds_per_span = ROUNDS_PER_SPAN
            transient_iters = max(32, int(np.ceil(transient_steps
                                                  / self.ppi)))
            block_steps = max(8, int(np.ceil(block_steps / self.ppi)))
            s = self.run(st, s, key, transient_iters, False)
            B = int(s.coords.shape[0])
            conv = jnp.zeros(B, bool)
            rnd = jnp.int32(0)
            rnd_h = 0
            while rnd_h < max_rounds:
                cap = jnp.int32(min(rnd_h + rounds_per_span, max_rounds))
                s, rnd, conv = self.run_rounds(st, s, key, conv, rnd, cap,
                                               block_steps)
                rnd_h = int(rnd)
                if bool(jax.device_get(conv.all())):
                    break
            return s, rnd_h, conv
        self.run_to_convergence = run_to_convergence


_BLOCK_CACHE: dict = {}
_BLOCK_LOCK = __import__("threading").Lock()


def get_block(N: int, M: int, use_vp: bool, use_pair: bool = False,
              use_ages: bool = False) -> "_Block":
    """Process-cached _Block instances. A fresh _Block per run_mcmc call
    re-jits (and re-lowers) every chain program — ~1.5 s of pure host
    tracing per tree batch at M=511 — so instances are cached by the
    static configuration; all batch data flows through arguments."""
    key = (N, M, use_vp, use_pair, use_ages, ROUNDS_PER_SPAN)
    blk = _BLOCK_CACHE.get(key)
    if blk is None:
        with _BLOCK_LOCK:       # overlapped slices race get_block
            blk = _BLOCK_CACHE.get(key)
            if blk is None:
                blk = _Block(N, M, use_vp, use_pair, use_ages)
                _BLOCK_CACHE[key] = blk
    return blk


def _initial_orders_batch(cl: np.ndarray, cr: np.ndarray, N: int,
                          rng: np.random.Generator):
    """Random linear extensions for a whole (B, M) tree batch at once.

    Vectorized replacement for per-tree :func:`_initial_order` (the host
    loop dominated run_mcmc's CPU time at 10^4-tree batches): draw a
    random key per internal node, push keys up so every parent exceeds
    its children (bottom-up fixed point over numpy arrays), and argsort —
    a random (not exactly uniform) linear extension; the initial order
    only seeds the burn-in (see module docstring deviations)."""
    B, M = cl.shape
    pseudo = np.zeros((B, M), dtype=np.float64)
    pseudo[:, N:] = rng.random((B, M - N))
    safe_l = np.maximum(cl, 0)
    safe_r = np.maximum(cr, 0)
    eps = 1e-9
    for _ in range(M):
        child_max = np.maximum(np.take_along_axis(pseudo, safe_l, axis=1),
                               np.take_along_axis(pseudo, safe_r, axis=1))
        nxt = np.where(cl >= 0, np.maximum(pseudo, child_max + eps),
                       pseudo)
        if np.array_equal(nxt, pseudo):
            break
        pseudo = nxt
    sidx = np.argsort(pseudo, axis=1, kind="stable").astype(np.int32)
    order = np.empty((B, M), dtype=np.int32)
    np.put_along_axis(order, sidx, np.arange(M, dtype=np.int32)[None, :],
                      axis=1)
    return sidx, order


def _initial_coords_batch(sidx: np.ndarray, N: int) -> np.ndarray:
    """(B, M) coalescent-prior starting ages (vectorized twin of
    :func:`_initial_coords`, contemporary samples)."""
    B, M = sidx.shape
    nl = np.concatenate([[N], 2 * N - np.arange(N + 1, M)]).astype(
        np.float64)
    cur = np.cumsum(2.0 / (nl * (nl - 1.0)))
    coords = np.zeros((B, M), dtype=np.float64)
    np.put_along_axis(coords, sidx[:, N:],
                      np.broadcast_to(cur, (B, M - N)), axis=1)
    return coords


def _initial_order(tree: Tree, rng: np.random.Generator):
    """Uniform random linear extension of the tree poset (contemporary)."""
    M = tree.num_nodes
    N = tree.N
    placed = np.zeros(M, dtype=bool)
    placed[:N] = True
    nchild_placed = np.zeros(M, dtype=np.int64)
    avail = []
    for v in range(N, M):
        c1, c2 = tree.child_left[v], tree.child_right[v]
        nchild_placed[v] = int(placed[c1]) + int(placed[c2])
        if nchild_placed[v] == 2:
            avail.append(v)
    sorted_idx = list(range(N))
    avail = list(avail)
    while avail:
        i = rng.integers(len(avail))
        v = avail.pop(i)
        sorted_idx.append(v)
        p = tree.parent[v]
        if p >= 0:
            nchild_placed[p] += 1
            if nchild_placed[p] == 2:
                avail.append(int(p))
    order = np.empty(M, dtype=np.int32)
    order[np.asarray(sorted_idx)] = np.arange(M)
    return np.asarray(sorted_idx, dtype=np.int32), order


def _initial_coords(sorted_idx: np.ndarray, N: int,
                    sample_ages=None) -> np.ndarray:
    """Coalescent-prior starting ages (InitializeBranchLengths,
    branch_length_estimator.cpp:61-136); with sample ages, lineage counts
    follow the sorted leaf/internal pattern and internal ages stack above
    the running maximum."""
    M = len(sorted_idx)
    coords = np.zeros(M, dtype=np.float64)
    if sample_ages is None:
        cur = 0.0
        for p in range(N, M):
            nl = N if p == N else 2 * N - p
            cur += 2.0 / (nl * (nl - 1.0))
            coords[sorted_idx[p]] = cur
        return coords
    coords[:N] = sample_ages
    cur = 0.0
    nl = 0
    for p in range(M):
        v = sorted_idx[p]
        if v < N:
            nl += 1
            cur = max(cur, coords[v])
        else:
            if nl >= 2:
                cur = cur + 2.0 / (nl * (nl - 1.0))
            else:
                cur = cur + 1e-6
            nl -= 1
            coords[v] = cur
    return coords


def _pseudo_order(tree: Tree, sample_ages: np.ndarray):
    """InitializeOrder (branch_length_estimator.cpp:138-212): stack an
    epsilon above each child along every leaf-to-root path, then argsort."""
    M = tree.num_nodes
    N = tree.N
    eps = 1.0 / np.log(max(N, 3)) / 10.0
    pseudo = np.zeros(M)
    pseudo[:N] = sample_ages
    for i in range(N):
        k2 = i
        while tree.parent[k2] >= 0:
            k1, k2 = k2, int(tree.parent[k2])
            if pseudo[k2] < pseudo[k1] + eps:
                pseudo[k2] = np.nextafter(pseudo[k1] + eps, np.inf)
    sorted_idx = np.lexsort((np.arange(M), pseudo)).astype(np.int32)
    order = np.empty(M, dtype=np.int32)
    order[sorted_idx] = np.arange(M)
    return sorted_idx, order


def branch_mut_rates(trees: List[Tree], dist: np.ndarray, L: int,
                     Ne: float, mu: float) -> np.ndarray:
    """mut_rate[i] = Ne*mu*(sum dist over SNP span + half edge SNPs)
    (InitializeMCMC, branch_length_estimator.cpp:214-237)."""
    S = np.zeros(L + 1, dtype=np.float64)
    np.cumsum(dist, out=S[1:])
    out = np.empty((len(trees), trees[0].num_nodes), dtype=np.float32)
    for t, tr in enumerate(trees):
        sb = tr.SNP_begin.astype(np.int64)
        se = tr.SNP_end.astype(np.int64)
        m = S[se] - S[sb]
        m = m + np.where(sb > 0, 0.5 * dist[np.maximum(sb - 1, 0)], 0.0)
        m = m + np.where(se < L - 1, 0.5 * dist[np.minimum(se, L - 1)], 0.0)
        out[t] = (Ne * mu) * m
    return out


def group_fractions(trees: List[Tree], memberships: np.ndarray,
                    num_groups: int) -> np.ndarray:
    """(B, M, G) per-node leaf group-fraction vectors
    (branch_length_estimator.cpp:4061-4066 computes the equivalent
    node-pair means leaf-pair by leaf-pair)."""
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    memberships = np.asarray(memberships, dtype=np.int64)
    out = np.zeros((B, M, num_groups), dtype=np.float32)
    eye = np.eye(num_groups, dtype=np.float64)
    for b, t in enumerate(trees):
        cnt = np.zeros((M, num_groups), dtype=np.float64)
        cnt[:N] = eye[memberships]
        parent = t.parent
        nch = np.zeros(M, dtype=np.int64)
        stack = list(range(N))       # push counts up, parents after children
        while stack:
            v = stack.pop()
            p = parent[v]
            if p < 0:
                continue
            cnt[p] += cnt[v]
            nch[p] += 1
            if nch[p] == 2:
                stack.append(int(p))
        out[b] = cnt / np.maximum(cnt.sum(axis=1, keepdims=True), 1.0)
    return out


def run_mcmc(trees: List[Tree], dist: np.ndarray, L: int,
             Ne: float = 3e4, mu: float = 1.25e-8, seed: int = 1,
             epochs: Optional[np.ndarray] = None,
             rates: Optional[np.ndarray] = None,
             sample_ages: Optional[np.ndarray] = None,
             group_R: Optional[np.ndarray] = None,
             memberships: Optional[np.ndarray] = None,
             max_rounds: int = 2000, mesh=None,
             mesh_axis: str = "shard",
             max_batch: Optional[int] = None) -> np.ndarray:
    """Estimate branch lengths for a batch of trees.

    epochs/rates: optional piecewise coalescence-rate prior in units of Ne
    generations (epochs ascending starting at 0); constant-Ne prior if None.
    group_R/memberships: optional pairwise group-rate prior — group_R is
    (E, G, G) rates per epoch (same Ne units) and memberships the (N,)
    group index per haplotype (MCMCCoalRatesForRelate).
    mesh: optional jax.sharding.Mesh — the independent chains (tree batch)
    are sharded over it (the replacement for the reference's
    section-level job arrays, SURVEY §2.5). The batch is padded with copies
    of the last tree to a device-count multiple; padded chains' outputs are
    dropped.
    Returns branch lengths (B, M) in generations.
    """
    if max_batch is None:
        max_batch = chain_batch_cap(trees[0].num_nodes)
    if len(trees) > max_batch:
        # slice very large tree batches: bounds device memory/program size
        # and keeps one compiled shape per slice size.
        # (A 2-worker thread pipeline overlapping slice s+1's host prep
        # with slice s's device run was tried and REVERTED: on a 2-core
        # host the GIL/CPU contention cost more than the overlap won.)
        outs = []
        for s in range(0, len(trees), max_batch):
            sl = trees[s: s + max_batch]
            outs.append(run_mcmc(
                sl, dist, L, Ne=Ne, mu=mu, seed=seed + 7 * (s + 1),
                epochs=epochs, rates=rates, sample_ages=sample_ages,
                group_R=group_R, memberships=memberships,
                max_rounds=max_rounds, mesh=mesh, mesh_axis=mesh_axis,
                max_batch=max_batch))
        return np.concatenate(outs, axis=0)
    B_real = len(trees)
    # pad the batch to a power-of-two bucket (and a device-count multiple
    # under a mesh) with copies of the last tree: bounds the number of
    # compiled chain-batch shapes to log2(max_batch); padded chains' outputs
    # are dropped
    bucket = 1 << max(B_real - 1, 0).bit_length()
    bucket = max(min(bucket, max_batch), 1)
    if mesh is not None:
        ndev = int(mesh.devices.size)
        bucket = -(-bucket // ndev) * ndev
    trees = list(trees) + [trees[-1]] * (bucket - B_real)
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    delta = int(max(N / 10.0, 10.0))
    rng = np.random.default_rng(seed)

    use_pair = group_R is not None
    use_vp = epochs is not None and not use_pair
    if use_vp:
        # one rate per boundary; interval i = [epochs[i], epochs[i+1]),
        # the last extending to infinity (.coal convention)
        ep = np.asarray(epochs, dtype=np.float64)
        E = len(ep)
        rt = np.broadcast_to(np.asarray(rates, dtype=np.float64), (B, E))
        cumR = np.zeros((B, E))
        widths = np.diff(ep)
        cumR[:, 1:] = np.cumsum(rt[:, : E - 1] * widths, axis=1)
        epochs_d = jnp.asarray(ep, jnp.float32)
        rates_d = jnp.asarray(rt, jnp.float32)
        cumR_d = jnp.asarray(cumR, jnp.float32)
    elif use_pair:
        ep = np.asarray(epochs, dtype=np.float64)
        epochs_d = jnp.asarray(ep, jnp.float32)
        rates_d = jnp.ones((B, 1), jnp.float32)
        cumR_d = jnp.zeros((B, 1), jnp.float32)
    else:
        epochs_d = jnp.asarray([0.0], jnp.float32)
        rates_d = jnp.ones((B, 1), jnp.float32)
        cumR_d = jnp.zeros((B, 1), jnp.float32)

    F_d = Rg_d = cumIRg_d = None
    if use_pair:
        Rgm = np.asarray(group_R, dtype=np.float64)     # (E, G, G)
        E, G = Rgm.shape[0], Rgm.shape[1]
        assert E == len(np.asarray(epochs)), "group_R epochs mismatch"
        cumIR = np.zeros((E, G, G))
        widths = np.diff(np.asarray(epochs, dtype=np.float64))
        cumIR[1:] = np.cumsum(Rgm[: E - 1] * widths[:, None, None], axis=0)
        F_d = jnp.asarray(group_fractions(trees, memberships, G))
        Rg_d = jnp.asarray(Rgm, jnp.float32)
        cumIRg_d = jnp.asarray(cumIR, jnp.float32)

    # position-indexed C(nl,2) (contemporary samples)
    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, 2 * N - 1)])
    kc2 = nl * (nl - 1) / 2.0

    parent = np.stack([t.parent for t in trees])
    cl = np.stack([t.child_left for t in trees])
    cr = np.stack([t.child_right for t in trees])
    nev = np.stack([t.num_events for t in trees])
    mrate = branch_mut_rates(trees, dist, L, Ne, mu)

    parent_d = jnp.asarray(parent, jnp.int32)
    depth_d = tree_depths_dev(parent_d)
    st = ChainStatic(
        parent=parent_d,
        child_left=jnp.asarray(cl, jnp.int32),
        child_right=jnp.asarray(cr, jnp.int32),
        num_events=jnp.asarray(nev, jnp.float32),
        mut_rate=jnp.asarray(mrate, jnp.float32),
        kc2_pos=jnp.asarray(kc2, jnp.float32),
        epochs=epochs_d, rates=rates_d, cumR=cumR_d,
        F=F_d, Rg=Rg_d, cumIRg=cumIRg_d,
        depth=depth_d)

    ages_n = None
    if sample_ages is not None and np.any(np.asarray(sample_ages) != 0):
        ages_n = np.asarray(sample_ages, dtype=np.float64) / Ne

    if ages_n is None:
        state, _ = device_init_state(parent_d, N, seed, depth_d)
    else:
        coords0 = np.empty((B, M), dtype=np.float32)
        order0 = np.empty((B, M), dtype=np.int32)
        sidx0 = np.empty((B, M), dtype=np.int32)
        for b, t in enumerate(trees):
            si, o = _pseudo_order(t, ages_n)
            coords0[b] = _initial_coords(si, N, ages_n)
            order0[b] = o
            sidx0[b] = si
        state = init_chain_state(coords0, order0, sidx0)

    if mesh is not None:
        from ..parallel.mesh import shard_batch
        st = shard_batch(mesh, st, B, mesh_axis)
        state = shard_batch(mesh, state, B, mesh_axis)

    block = get_block(N, M, use_vp, use_pair, use_ages=ages_n is not None)
    key = jax.random.PRNGKey(seed)

    # Transient + PER-TREE convergence loop, all in one device program:
    # the reference converges each tree independently
    # (branch_length_estimator.cpp:2983-3073); here converged chains freeze
    # (their state and running sums stop updating) while the rest continue,
    # and the only host<->device round-trip per batch is the final download.
    block_steps = max(delta, 128)
    import time as _time
    t_dev0 = _time.time()
    state, _rounds, _conv = block.run_to_convergence(
        st, state, key, 50 * delta, block_steps, max_rounds)

    final_ssum = np.asarray(state.ssum, dtype=np.float64)
    final_count = np.asarray(state.count, dtype=np.float64)
    if os.environ.get("RELATE_TPU_TRACE_FINE"):
        import sys as _sys
        print(f"[fine]   run_mcmc B={B} M={M}: device+download "
              f"{_time.time() - t_dev0:.2f}s rounds={_rounds}",
              file=_sys.stderr)

    avg = final_ssum / np.maximum(final_count, 1.0)[:, None]
    pav = np.take_along_axis(avg, np.maximum(parent, 0), axis=1)
    bl = np.where(parent >= 0, Ne * (pav - avg), 0.0)
    return np.maximum(bl, 0.0)[:B_real]
