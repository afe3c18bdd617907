"""Multi-chip sharding of the Relate pipeline.

The reference's entire distributed story is shell-level job arrays over a
shared filesystem (SURVEY §2.5: chunks x sections via SGE/Slurm/LSF, with
"write per-shard matrices, sum in a finalize step" as the all-reduce;
scripts/RelateParallel/RelateParallel.sh:231-396,
scripts/RelateSGE/RelateSGE.sh:208-520). The replacement here:

- **targets axis** (haplotypes being painted): embarrassingly parallel —
  sharded across the devices of a host; each device paints its target
  shard against the replicated genotype panel.
- **trees axis** (branch-length MCMC chains): independent chains, sharded
  across devices.
- **chunks axis** (genome): data-parallel across hosts; artifacts
  merged at host 0 in Finalize.
- **reductions** (coalescence count/opportunity matrices, EM sufficient
  statistics): ``psum`` inside ``shard_map`` over the device mesh instead
  of the reference's filesystem sum
  (SummarizeCoalescentRateForGenome.cpp:8).

``multichip_step`` is the canonical sharded step used by the driver's
multi-chip dry run: a painting forward pass sharded over targets, an MCMC
proposal block sharded over trees, and a psum'd count-matrix reduction.

Sharding rule: a ``ChainStatic``/``ChainState`` mixes batch-leading (B, ...)
arrays with replicated per-tree constants (``kc2_pos`` (M,), ``epochs`` (E,),
``Rg`` (E, G, G)). ``shard_batch`` therefore shards ONLY leaves whose leading
axis equals the batch size and replicates everything else — a blanket
P('shard') placement would try to split the (M,)/(E,) constants across
devices and fail whenever they don't divide the mesh.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import mcmc, painting
from ..core.trees import Tree


def default_mesh(n_devices: Optional[int] = None,
                 axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                f"jax device(s) are visible ({devs[0].platform}). For a "
                "virtual CPU mesh set XLA_FLAGS=--xla_force_host_platform_"
                "device_count=N and jax.config.update('jax_platforms','cpu') "
                "before first use.")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, tree, batch_size: int, axis: str = "shard"):
    """Place a pytree on the mesh: leaves whose leading axis == batch_size
    are sharded over ``axis``; all other leaves (per-tree constants like
    ``kc2_pos``/``epochs``/``Rg``) are replicated."""
    row = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def place(x):
        x = jnp.asarray(x)
        sh = row if (x.ndim >= 1 and x.shape[0] == batch_size) else repl
        return jax.device_put(x, sh)

    return jax.tree.map(place, tree)


def make_sharded_paint_fn(mesh: Mesh, model: painting.PaintingModel,
                          axis: str = "shard"):
    """Painting forward pass with the target-batch axis sharded over the
    mesh; G replicated. Returns a jitted fn of
    (G, idx, seqk, pfac, nxt, D, kmask, alpha0)."""
    fwd, _, _ = painting.make_painting_kernels(model)
    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(axis))

    def fn(G, idx, seqk, pfac, nxt, D, kmask, alpha0):
        return fwd(G, idx, seqk, pfac, nxt, D, kmask, alpha0)

    return jax.jit(
        fn,
        in_shardings=(repl, row, row, row, row, row, row, row),
        out_shardings=(NamedSharding(mesh, P(None, axis)),
                       NamedSharding(mesh, P(None, axis))))


def coalescence_counts_psum(mesh: Mesh, ages, epochs, axis: str = "shard"):
    """Per-epoch coalescence-event counts, reduced with a real ``psum``
    across the mesh (replacing the reference's filesystem sum of per-shard
    .bin matrices, SummarizeCoalescentRateForGenome.cpp:8).

    ``ages``: (B, M) node ages with B sharded over ``axis`` (or a host array
    — it is placed on the mesh here). Returns a replicated (E,) count
    vector identical on every device.
    """
    ages = jax.device_put(jnp.asarray(ages), NamedSharding(mesh, P(axis)))
    epochs = jax.device_put(jnp.asarray(epochs), NamedSharding(mesh, P()))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis), P()), out_specs=P())
    def reduce_counts(a, ep):
        e = jnp.searchsorted(ep, a, side="right") - 1
        onehot = jax.nn.one_hot(e, ep.shape[0], dtype=jnp.float32)
        local = onehot.sum(axis=tuple(range(a.ndim)))
        return jax.lax.psum(local, axis)

    return reduce_counts(ages, epochs)


def multichip_step(mesh: Mesh, model: painting.PaintingModel,
                   paint_args, mcmc_static: mcmc.ChainStatic,
                   mcmc_state: mcmc.ChainState, key, epochs,
                   axis: str = "shard"):
    """One full sharded pipeline step:
    paint (targets sharded) -> MCMC proposals (trees sharded) ->
    coalescence-count psum (the EM sufficient statistic all-reduce).
    """
    N = int(mcmc_static.parent.shape[1] + 1) // 2
    M = int(mcmc_static.parent.shape[1])
    B = int(mcmc_static.parent.shape[0])
    step = mcmc.make_step_fn(N, M, False)

    @partial(jax.jit,
             out_shardings=(NamedSharding(mesh, P(None, axis)),
                            None, NamedSharding(mesh, P())))
    def run(G, idx, seqk, pfac, nxt, D, kmask, alpha0, st, s, key):
        fwd, _, _ = painting.make_painting_kernels(model)
        alphas, ls = fwd(G, idx, seqk, pfac, nxt, D, kmask, alpha0)
        s2 = step(st, s, key, True)

        def count_fn(coords):
            e = jnp.searchsorted(epochs, coords, side="right") - 1
            onehot = jax.nn.one_hot(e, len(epochs), dtype=jnp.float32)
            return onehot.sum(axis=(0, 1))

        counts = count_fn(s2.coords)
        return alphas, s2, counts

    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(axis))
    G, idx, seqk, pfac, nxt, D, kmask, alpha0 = paint_args
    G = jax.device_put(G, repl)
    paint_sharded = [jax.device_put(x, row)
                     for x in (idx, seqk, pfac, nxt, D, kmask, alpha0)]
    st = shard_batch(mesh, mcmc_static, B, axis)
    s = shard_batch(mesh, mcmc_state, B, axis)
    return run(G, *paint_sharded, st, s, key)


def dryrun(n_devices: int):
    """Compile-and-run a full multi-chip step on tiny shapes.

    Builds an ``n_devices`` mesh (raising, not silently shrinking, when
    fewer devices are visible), shards the painting target axis and the
    MCMC tree axis across it, jits the combined step with real
    NamedShardings, executes one step, and runs the shard_map psum
    all-reduce on the resulting node ages.
    """
    mesh = default_mesh(n_devices)
    rng = np.random.default_rng(0)
    # tiny panel: N=16 haps x L=64 SNPs; targets = all haps
    N, L = 16, 64
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    r = np.full(L, 1e-4)
    model = painting.PaintingModel(N=N, theta=0.001)
    plan = painting.build_target_plan(G, r, model, 0, L - 1)
    alpha0 = painting.initial_alpha(G, model, 0, plan.targets)
    paint_args = (jnp.asarray(G), jnp.asarray(plan.idx),
                  jnp.asarray(plan.seqk), jnp.asarray(plan.pfac),
                  jnp.asarray(plan.nxt), jnp.asarray(plan.D),
                  jnp.asarray(plan.kmask), jnp.asarray(alpha0))

    # tiny tree batch: two trees per device
    B = 2 * n_devices
    from ..core.treebuilder import quick_build
    d = rng.random((N, N)).astype(np.float32)
    tree = quick_build(d, theta=0.01)
    trees = [tree] * B
    dist = np.ones(L)
    M = tree.num_nodes

    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, M)])
    kc2 = (nl * (nl - 1) / 2.0).astype(np.float32)
    st = mcmc.ChainStatic(
        parent=jnp.asarray(np.stack([t.parent for t in trees])),
        child_left=jnp.asarray(np.stack([t.child_left for t in trees])),
        child_right=jnp.asarray(np.stack([t.child_right for t in trees])),
        num_events=jnp.zeros((B, M), jnp.float32),
        mut_rate=jnp.asarray(mcmc.branch_mut_rates(trees, dist, L, 3e4,
                                                   1e-8)),
        kc2_pos=jnp.asarray(kc2),
        epochs=jnp.asarray([0.0, np.inf], jnp.float32),
        rates=jnp.ones((B, 1), jnp.float32),
        cumR=jnp.zeros((B, 2), jnp.float32))
    coords0 = np.zeros((B, M), np.float32)
    order0 = np.zeros((B, M), np.int32)
    sidx0 = np.zeros((B, M), np.int32)
    for b in range(B):
        si, o = mcmc._initial_order(tree, np.random.default_rng(b))
        coords0[b] = mcmc._initial_coords(si, N)
        order0[b] = o
        sidx0[b] = si
    s = mcmc.init_chain_state(coords0, order0, sidx0)

    epochs = jnp.asarray([0.0, 0.5, 1.0, 2.0], jnp.float32)
    alphas, s2, counts = multichip_step(mesh, model, paint_args, st, s,
                                        jax.random.PRNGKey(0), epochs)
    jax.block_until_ready((alphas, s2.coords, counts))
    assert np.isfinite(np.asarray(counts)).all()
    # the explicit shard_map psum all-reduce (the EM sufficient-statistic
    # path) must execute on the same mesh
    psum_counts = coalescence_counts_psum(mesh, s2.coords, epochs)
    jax.block_until_ready(psum_counts)
    assert np.isfinite(np.asarray(psum_counts)).all()
    # in-jit reduction and explicit psum must agree
    np.testing.assert_allclose(np.asarray(counts), np.asarray(psum_counts),
                               rtol=1e-6)
    return counts
