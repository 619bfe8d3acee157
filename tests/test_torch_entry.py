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
        "import poms_tpu_torch.sparse, poms_tpu_torch.core.matrix\n"
        "import poms_tpu_torch.ops.dispatch, poms_tpu_torch.mg.solver\n"
        "import poms_tpu_torch.bench.one_impl\n"
        "import poms_tpu_torch.bench.kernel_probe\n"
        "import poms_tpu_torch.bench.profile_banded\n"
        "import poms_tpu_torch.bench.roofline, poms_tpu_torch.ops.stencil_v2\n"
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


def _refuses(args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the bench would run")
    proc = _run(["-m", *args])
    assert proc.returncode != 0
    assert "RESULT" not in proc.stdout
    return proc


def test_one_impl_refuses_without_a_card():
    _refuses(["poms_tpu_torch.bench.one_impl", "k2", "3", "16", "3"])


def test_one_impl_k3_refuses_without_a_card():
    """K3 never falls back to K2 or to the CPU."""
    _refuses(["poms_tpu_torch.bench.one_impl", "k3", "3", "16", "3"])


def test_kernel_probe_refuses_without_a_card():
    proc = _refuses(["poms_tpu_torch.bench.kernel_probe", "compute", "16",
                     "1"])
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("probe", ["stream", "streamc", "v15", "ablate"])
def test_each_kernel_probe_refuses_without_a_card(probe):
    proc = _refuses(["poms_tpu_torch.bench.kernel_probe", probe, "16", "1"])
    assert "no CUDA device" in proc.stderr


def test_profile_banded_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the profile would run")
    proc = _run(["-m", "poms_tpu_torch.bench.profile_banded", "8", "2", "1"])
    assert proc.returncode != 0
    assert "RESULT" not in proc.stdout
