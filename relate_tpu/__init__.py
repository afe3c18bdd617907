"""relate-tpu: a genealogy-inference framework in JAX.

Re-implements the capabilities of Relate (Speidel et al., Nature Genetics 2019;
reference C++ at MyersGroup/relate) as an idiomatic JAX/XLA/Pallas framework:

- Li & Stephens chromosome-painting HMM as batched device scans
  (``relate_tpu.core.painting``), replacing ``include/src/fast_painting.cpp``.
- Distance-matrix assembly + MinMatch hierarchical tree building as vectorized
  JAX programs (``relate_tpu.core.distance``, ``relate_tpu.core.treebuilder``),
  replacing ``include/src/tree_builder.cpp`` / ``anc_builder.cpp``.
- Branch-length MCMC under the coalescent, vmapped over trees
  (``relate_tpu.core.mcmc``), replacing ``include/src/branch_length_estimator.cpp``.
- Population-size / mutation-rate EM and selection scans with on-device
  sufficient statistics (``relate_tpu.evaluate``), replacing
  ``include/evaluate/*``.
- Multi-host/multi-chip scaling via ``jax.sharding`` meshes
  (``relate_tpu.parallel``), replacing the RelateParallel/SGE/Slurm shell layer.
"""

__version__ = "0.1.0"

import os as _os


def _enable_compilation_cache():
    """Persistent XLA compilation cache (opt out: RELATE_TPU_CACHE=0).

    The painting/topology programs take a while to compile for a new panel
    shape; caching makes repeat runs (and multi-process pipelines) start
    faster. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
    and no other directory is set here; otherwise the cache is the fixed
    ``.jax_cache/`` of this checkout (a fixed path, so entries are found
    again)."""
    if _os.environ.get("RELATE_TPU_CACHE", "1") == "0":
        return
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def cache_dir() -> str:
    """The compile-cache directory this package uses."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


_enable_compilation_cache()
