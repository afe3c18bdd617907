"""Runtime rules that decide where things live: the device-memory budget
the window planner sizes from, and the compile-cache directory."""
import os
import types

import jax
import pytest

import relate_tpu
from relate_tpu.utils import devmem


def _fake_device(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind="fake",
                                 memory_stats=lambda: stats)


def test_device_hbm_gb_cpu_is_explicit(monkeypatch):
    monkeypatch.delenv("RELATE_TPU_HBM_GB", raising=False)
    assert devmem.device_hbm_gb() == devmem.CPU_BUDGET_GB
    assert devmem.auto_memory_gb() == devmem.CPU_BUDGET_GB / 20.0


def test_device_hbm_gb_reads_gpu_bytes_limit(monkeypatch):
    monkeypatch.delenv("RELATE_TPU_HBM_GB", raising=False)
    dev = _fake_device("gpu", {"bytes_limit": 60e9, "bytes_in_use": 0})
    monkeypatch.setattr(jax, "local_devices", lambda: [dev])
    assert devmem.device_hbm_gb() == 60.0
    assert devmem.auto_memory_gb() == 3.0
    monkeypatch.setenv("RELATE_TPU_HBM_GB", "8")
    assert devmem.device_hbm_gb() == 8.0


@pytest.mark.parametrize("stats", [{}, None])
def test_device_hbm_gb_gpu_without_limit_raises(monkeypatch, stats):
    monkeypatch.delenv("RELATE_TPU_HBM_GB", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_fake_device("gpu", stats)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        devmem.device_hbm_gb()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the package sets no other."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert relate_tpu.cache_dir() == str(tmp_path)
    relate_tpu._enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert relate_tpu.cache_dir() == want
    relate_tpu._enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == want
