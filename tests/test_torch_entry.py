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
        "import poms_tpu_torch.bench.one_solve, poms_tpu_torch.mg.graph\n"
        "import poms_tpu_torch.ops.counters, poms_tpu_torch.mg.mixed\n"
        "import poms_tpu_torch.utils.logging\n"
        "import poms_tpu_torch.utils.checkpoint\n"
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


@pytest.mark.parametrize("module", ["k1_compare", "profile_dw", "one_solve"])
def test_kron_benches_refuse_without_a_card(module):
    proc = _refuses([f"poms_tpu_torch.bench.{module}"])
    assert "no CUDA device" in proc.stderr


def test_no_source_of_the_port_imports_jax():
    """No module under poms_tpu_torch/, nor chip_smoke.py, names jax or the
    JAX package in an import statement."""
    import ast
    import pathlib

    files = sorted(pathlib.Path(REPO, "poms_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(REPO, "chip_smoke.py"))
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            bad = [n for n in names
                   if n.split(".")[0] in ("jax", "jaxlib", "poms_tpu")]
            assert not bad, (str(path), bad)


def test_launch_counters_snapshot_add_reset():
    """The registry a graph replay advances: every wrapper is in it."""
    from poms_tpu_torch.ops import counters
    from poms_tpu_torch.ops.transfer import apply_transfer
    from poms_tpu_torch.ops.twofloat import dw_dot_stack, dw_update

    before = counters.snapshot()
    for key in ("kron_mode.cheb", "kron_mode.apply", "residual_kron_df",
                "dw_reduce", "dw_update", "transfer", "stencil_apply.spmv",
                "stencil_apply_v2.rbgs", "kron_apply"):
        assert key in before
    counters.add({"dw_reduce": 3, "kron_mode.cheb": 32, "transfer": 24})
    after = counters.snapshot()
    assert counters.diff(after, before) == {"dw_reduce": 3,
                                            "kron_mode.cheb": 32,
                                            "transfer": 24}
    assert dw_dot_stack.launches == before["dw_reduce"] + 3
    assert apply_transfer.launches == before["transfer"] + 24
    counters.add({k: -v for k, v in counters.diff(after, before).items()})
    assert counters.snapshot() == before
    assert dw_update.launches == before["dw_update"]


def test_graphed_step_needs_the_card():
    from poms_tpu_torch.mg.graph import GraphedStep

    with pytest.raises(ValueError, match="CUDA"):
        GraphedStep(lambda x: (x, x.sum()), [torch.zeros(3)])


@pytest.mark.parametrize("prof,stream,graph,want,told", [
    (0.040, 0.050, None, 0.040, False),   # agrees with the events: kept
    (0.004, 0.050, 0.040, 0.040, True),   # lost events: the graph's time
    (0.0145, 0.045, 0.041, 0.041, True),  # lost two thirds of them
    (0.004, 0.050, 0.006, 0.004, False),  # host gaps only: kept
    (0.004, 0.050, "raise", 0.004, False),  # not capturable: kept
])
def test_device_ms_checks_the_profile_against_events(monkeypatch, capsys,
                                                     prof, stream, graph,
                                                     want, told):
    """A profile under half the stream's event time is held against a
    replayed graph's; only under half of that too is it replaced."""
    from poms_tpu_torch.bench import device

    def graph_ms(fn, reps):
        if graph is None:
            raise AssertionError("the graph was not needed")
        if graph == "raise":
            raise RuntimeError("synchronises")
        return graph

    monkeypatch.setattr(device, "profiler_ms",
                        lambda fn, reps, with_cpu=False, kernels=None: prof)
    monkeypatch.setattr(device, "stream_event_ms", lambda fn, reps: stream)
    monkeypatch.setattr(device, "graph_event_ms", graph_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert device.device_ms(lambda: None, 4) == want
    assert ("lost device events" in capsys.readouterr().err) == told


@pytest.mark.parametrize("capturable", [True, False])
def test_device_ms_falls_back_to_events(monkeypatch, capsys, capturable):
    """Three empty profiles (the third with the CPU's activity too), then
    the graph's event time, then the stream's: the order of the clocks."""
    from poms_tpu_torch.bench import device
    asked = []

    def no_profile(fn, reps, with_cpu=False, kernels=None):
        asked.append(with_cpu)

    def graph(fn, reps):
        if not capturable:
            raise RuntimeError("synchronises")
        return 0.25

    monkeypatch.setattr(device, "profiler_ms", no_profile)
    monkeypatch.setattr(device, "graph_event_ms", graph)
    monkeypatch.setattr(device, "stream_event_ms", lambda fn, reps: 0.5)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    ms = device.device_ms(lambda: calls.append(1), 4)
    assert asked == [False, False, True] and calls == [1]
    assert ms == (0.25 if capturable else 0.5)
    err = capsys.readouterr().err
    assert "no device time" in err
    assert ("replayed graph" in err) == capturable


@pytest.mark.parametrize("counts,want", [
    ({"k1r_pass_a": 4, "k1r_pass_b": 4, "k1r_pass_c": 4}, 0.03),
    ({"k1r_pass_a": 4, "k1r_pass_b": 4, "k1r_pass_c": 3}, None),  # lost one
    ({"k1r_pass_a": 4, "k1r_pass_b": 4}, None),        # lost a whole pass
])
def test_profiler_ms_refuses_a_profile_that_lost_a_kernel(monkeypatch,
                                                          counts, want):
    """Given the kernels a call launches, a profile holding another count
    of them is None (lost), however much device time it read."""
    import torch.profiler

    from poms_tpu_torch.bench import device

    class Event:
        def __init__(self, key, count):
            self.key, self.count = key, count
            self.device_type = torch.autograd.DeviceType.CUDA
            self.self_device_time_total = 10.0 * count   # µs

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [Event(f"void {k}<float, float>(Args)", n)
                    for k, n in counts.items()]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms = device.profiler_ms(lambda: None, 4, kernels=("k1r_pass_", 3))
    assert ms == pytest.approx(want) if want else ms is None
    # without the kernels asked for, the time is taken as it came
    assert device.profiler_ms(lambda: None, 4) == pytest.approx(
        sum(counts.values()) * 10.0 / 1e3 / 4)


def test_device_ms_says_which_kernels_the_profiles_lost(monkeypatch, capsys):
    """Three profiles that lost kernels of the calls: the graph's event
    time, and the line on the standard error names the kernels."""
    from poms_tpu_torch.bench import device

    asked = []

    def lost(fn, reps, with_cpu=False, kernels=None):
        asked.append(kernels)

    monkeypatch.setattr(device, "profiler_ms", lost)
    monkeypatch.setattr(device, "graph_event_ms", lambda fn, reps: 0.25)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert device.device_ms(lambda: None, 4, ("k5r_pass_", 3)) == 0.25
    assert asked == [("k5r_pass_", 3)] * 3
    assert "not 3 k5r_pass_ kernels a call" in capsys.readouterr().err
