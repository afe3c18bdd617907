import os

# Tests run on the CPU, with a virtual 8-device mesh so multi-device
# sharding logic is exercised without the cards (`python chip_smoke.py`
# runs the GPU paths). Must be set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# persistent compile cache: repeated test runs skip recompiles. The package
# keeps it where JAX_COMPILATION_CACHE_DIR says, else in <checkout>/.jax_cache
import relate_tpu  # noqa: E402,F401

jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, so every
    worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")


@pytest.fixture(scope="session")
def golden_dir(tmp_path_factory):
    """Decompress golden fixtures (reference-binary outputs) to a temp dir."""
    if not GOLDEN.exists():
        pytest.skip("golden fixtures not present")
    out = tmp_path_factory.mktemp("golden")
    for p in GOLDEN.iterdir():
        if p.is_dir():
            continue
        if p.suffix == ".gz":
            with gzip.open(p, "rb") as f_in, open(out / p.stem, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
        else:
            shutil.copy(p, out / p.name)
    return out


@pytest.fixture(scope="session")
def golden_chunk(golden_dir):
    from relate_tpu.io import chunking
    return chunking.read_reference_chunk(str(golden_dir / "chunk_0"))
