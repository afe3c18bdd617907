"""Per-stage resource tracing.

The reference prints CPU time + max RSS via getrusage at the end of every
tool (e.g. ``include/pipeline/Paint.cpp:96-105``). This analog adds
device-side numbers: per-stage wall clock, host CPU time, max RSS, and
(when the backend exposes it) each local device's peak memory in use.

Usage::

    with stage("paint"):
        ...
    # -> [trace] paint: wall 3.21s cpu 2.87s rss 412MB device_peak [96]MB

Structured records accumulate in ``STAGES`` so ``run_all`` can print a
final per-stage summary table (and tests can assert on it).
"""
from __future__ import annotations

import contextlib
import resource
import sys
import time
from typing import List, Optional

STAGES: List[dict] = []


def _rss_mb() -> float:
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1000.0


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _device_peaks_mb() -> Optional[List[float]]:
    """Peak bytes in use on each local device, in MB, when the backend
    reports it (GPU runtimes do; the CPU returns None). The peak is the
    process's so far, not the stage's alone."""
    import jax
    stats = [d.memory_stats() for d in jax.local_devices()]
    if not all(stats):
        return None
    return [round(st["peak_bytes_in_use"] / 1e6, 1) for st in stats]


@contextlib.contextmanager
def stage(name: str, verbose: bool = True):
    """Time a pipeline stage; record + optionally print its resource use."""
    t0 = time.time()
    c0 = _cpu_s()
    yield
    rec = {
        "stage": name,
        "wall_s": round(time.time() - t0, 3),
        "cpu_s": round(_cpu_s() - c0, 3),
        "max_rss_mb": round(_rss_mb(), 1),
    }
    peaks = _device_peaks_mb()
    if peaks is not None:
        rec["device_peak_mb"] = peaks
    STAGES.append(rec)
    if verbose:
        msg = (f"[trace] {name}: wall {rec['wall_s']}s "
               f"cpu {rec['cpu_s']}s rss {rec['max_rss_mb']}MB")
        if peaks is not None:
            msg += f" device_peak {peaks}MB"
        print(msg, file=sys.stderr)


def summary(verbose: bool = True) -> List[dict]:
    """Per-stage records accumulated so far; optionally print a table."""
    if verbose and STAGES:
        w = max(len(r["stage"]) for r in STAGES)
        print(f"[trace] {'stage'.ljust(w)}  wall_s  cpu_s  rss_mb",
              file=sys.stderr)
        for r in STAGES:
            print(f"[trace] {r['stage'].ljust(w)}  "
                  f"{r['wall_s']:6.2f}  {r['cpu_s']:5.2f}  "
                  f"{r['max_rss_mb']:6.1f}", file=sys.stderr)
    return list(STAGES)
