"""Entry points of the PyTorch port: no jax at run time, no CPU fallback."""
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _run(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    proc = _run(["-c", (
        "import sys\n"
        "import poms_tpu_torch, poms_tpu_torch.convert\n"
        "import poms_tpu_torch.bench.one_pcg, poms_tpu_torch.ops.twofloat\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'poms_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')")])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX" in proc.stdout


def test_chip_smoke_refuses_without_a_card():
    """No CUDA card here: chip_smoke.py must fail and print no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_one_pcg_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the bench would run")
    proc = _run(["-m", "poms_tpu_torch.bench.one_pcg", "16"])
    assert proc.returncode != 0
    assert "RESULT" not in proc.stdout
