"""chip_smoke.py's parent side, which runs on any machine: it starts no
JAX backend and only reads what its child phases print."""
import sys

import pytest

import chip_smoke


def _child(code):
    return [sys.executable, "-c", code]


def test_run_child_echoes_output_and_reads_device(capsys):
    dev = chip_smoke._run_child(_child(
        "print('phase 1 ok', flush=True);"
        "print('SMOKE_DEVICE {\"platform\": \"gpu\", \"kind\": \"k\", "
        "\"count\": 1}')"), timeout=60)
    assert dev == {"platform": "gpu", "kind": "k", "count": 1}
    out = capsys.readouterr().out
    assert "phase 1 ok" in out and "SMOKE_DEVICE" not in out


@pytest.mark.parametrize("code", [
    "import sys; print('partial', flush=True); sys.exit(3)",
    "print('no device line')",
    "import time; print('slow', flush=True); time.sleep(30)"])
def test_run_child_failure_prints_no_result(code, capsys):
    with pytest.raises(SystemExit):
        chip_smoke._run_child(_child(code), timeout=5)
    assert "{\"ok\"" not in capsys.readouterr().out
