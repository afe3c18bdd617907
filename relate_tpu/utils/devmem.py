"""Device-memory introspection for window planning.

The reference sizes windows from a user --memory budget (default 5 GB,
data.cpp:129,219-229) and runs out of memory when the user guesses high.
On an accelerator the honest budget is what the device's allocator may
hand out: query it. A GPU runtime always reports it; a CPU run has no
device memory of its own, so the planner gets an explicit host budget.
"""
from __future__ import annotations

import os

# window-planner device budget of a CPU run (tests, laptops): the host
# holds the posteriors, and small windows keep its memory modest
CPU_BUDGET_GB = 16.0


def device_hbm_gb() -> float:
    """Memory the first device's allocator may use, in GB.

    ``RELATE_TPU_HBM_GB`` overrides it (a deployment setting, e.g. to share
    a card). On a GPU it is ``memory_stats()["bytes_limit"]``; a GPU
    runtime that does not report it is an error. A CPU run gets
    :data:`CPU_BUDGET_GB`."""
    env = os.environ.get("RELATE_TPU_HBM_GB")
    if env:
        return float(env)
    import jax
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return CPU_BUDGET_GB
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{dev.device_kind}: the runtime reports no bytes_limit in "
            "memory_stats(); set RELATE_TPU_HBM_GB to size windows")
    return stats["bytes_limit"] / 1e9


def auto_memory_gb() -> float:
    """Window-planner budget derived from real device memory.

    The planner's budget counts 4-byte posterior floats (the reference's
    model); on the device a window's posterior is padded to its longest
    target's step count and a 32-step bucket, and two posteriors can be
    live transiently. budget = memory/20, capped at the reference's 5 GB
    default, leaves room for the merge matrices and the device-resident
    checkpoint slabs.
    """
    return max(0.25, min(5.0, device_hbm_gb() / 20.0))
