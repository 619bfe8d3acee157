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
        "import poms_tpu_torch.bench.k1_compare\n"
        "import poms_tpu_torch.bench.profile_dw\n"
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


def test_default_device_is_the_card_or_an_error():
    """Without ``device`` the entry points use the current CUDA card; with
    no card they raise: never a quiet CPU run."""
    from poms_tpu_torch.core.space import (StencilVectorSpace,
                                           resolve_device)
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops.stencil import color_mask
    from poms_tpu_torch.ops.transfer import bands_from_dense

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        card = torch.device("cuda", torch.cuda.current_device())
        assert resolve_device() == card
        assert StencilVectorSpace(npts=(4,), pads=1).device == card
        assert poisson_problem(1, 8, degree=2).space.device == card
        return
    import numpy as np

    for call in (resolve_device,
                 lambda: StencilVectorSpace(npts=(4,), pads=1),
                 lambda: poisson_problem(1, 8, degree=2),
                 lambda: poisson_problem(2, 4, degree=2, operator="kron"),
                 lambda: color_mask((4, 4), 0),
                 lambda: bands_from_dense(np.eye(3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert poisson_problem(1, 8, degree=2,
                           device="cpu").space.device.type == "cpu"


@pytest.mark.parametrize("module", ["k1_compare", "profile_dw"])
def test_kron_benches_refuse_without_a_card(module):
    proc = _refuses([f"poms_tpu_torch.bench.{module}"])
    assert "no CUDA device" in proc.stderr
