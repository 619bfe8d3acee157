"""``bench/overlap_trace.py`` on ``torch.profiler``: the interval math and
the classification cases of ``tests/test_overlap_trace.py`` (the JAX
package's event names, and the same cases with the names a PyTorch trace
holds), the step-span shares, and one 2-rank gloo capture of the A/B pair
on the CPU (which shows the machinery, not a card's overlap).
"""
import json

import pytest

from poms_tpu_torch.bench.overlap_trace import (_intersect_len, _merge,
                                                overlap_report,
                                                parse_perfetto,
                                                run_overlap_ab)


def test_interval_math():
    assert _merge([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert _intersect_len([[0, 10]], [[2, 4], [8, 12]]) == 4.0
    assert _merge([]) == []


@pytest.mark.parametrize("comm,compute", [
    # the host's names of a CPU rank: gloo's send, the arithmetic ops
    ({"name": "gloo:send", "cat": "user_annotation"},
     [{"name": "aten::mul", "cat": "cpu_op"},
      {"name": "aten::add", "cat": "cpu_op"}]),
    # a card's: a NCCL kernel, K2 and a staged copy
    ({"name": "ncclDevKernel_SendRecv(ncclDevComm*)", "cat": "kernel"},
     [{"name": "stencil_apply_kernel<float, 3>", "cat": "kernel"},
      {"name": "k7_transfer_kernel", "cat": "kernel"}]),
])
def test_overlap_report_classification(comm, compute):
    """The JAX case's intervals: comm [0, 10], compute [2, 6] and
    [20, 25] → 4 of 10 µs overlapped."""
    events = [dict(comm, ts=0.0, dur=10.0), dict(compute[0], ts=2.0,
                                                 dur=4.0),
              dict(compute[1], ts=20.0, dur=5.0)]
    rep = overlap_report(events)
    assert rep["n_comm_events"] == 1
    assert rep["n_compute_events"] == 2
    assert rep["overlapped_us"] == 4.0
    assert abs(rep["overlap_fraction"] - 0.4) < 1e-12


def test_copies_are_comm_and_the_span_gives_the_shares():
    events = [
        {"name": "overlap_step", "cat": "user_annotation", "ts": 0.0,
         "dur": 100.0},
        {"name": "Memcpy DtoH (Device -> Pageable)", "cat": "gpu_memcpy",
         "ts": 10.0, "dur": 10.0},
        {"name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "ts": 40.0, "dur": 10.0},
        {"name": "stencil_apply_kernel", "cat": "kernel", "ts": 15.0,
         "dur": 20.0},
        {"name": "aten::mul", "cat": "cpu_op", "ts": 0.0, "dur": 90.0},
    ]
    rep = overlap_report(events)
    assert rep["n_comm_events"] == 2 and rep["n_compute_events"] == 1
    assert rep["comm_wall_us"] == 20.0 and rep["overlapped_us"] == 5.0
    assert rep["step_wall_us"] == 100.0
    assert rep["device_busy_us"] == 35.0          # [10, 35] and [40, 50]
    assert abs(rep["device_idle_share"] - 0.65) < 1e-12
    assert rep["copy_us"] == 20.0 and abs(rep["copy_share"] - 0.2) < 1e-12
    assert overlap_report([])["overlap_fraction"] is None


def test_parse_keeps_complete_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 1,
         "dur": 2},
        {"ph": "B", "name": "aten::mul", "ts": 1},
        {"ph": "X", "name": "PyTorch Profiler (0)", "cat": "Trace",
         "ts": 0, "dur": 9}]}))
    events = parse_perfetto(str(path))
    assert [e["name"] for e in events] == ["aten::add"]
    assert events[0]["cat"] == "cpu_op" and events[0]["dur"] == 2.0


def test_capture_ab_on_two_gloo_ranks(tmp_path):
    """End to end: every rank profiles one distributed step per arm; both
    arms parse, hold gloo messages and arithmetic, and give fractions in
    range; rank 0's report is written."""
    rep = run_overlap_ab(str(tmp_path / "ab.json"), n_el=16,
                         backend="gloo", ranks=2, device="cpu")
    for arm in ("overlap_true", "overlap_false"):
        r = rep[arm]
        assert r["n_comm_events"] > 0 and r["n_compute_events"] > 0, r
        f = r["overlap_fraction"]
        assert f is None or 0.0 <= f <= 1.0
        assert r["step_wall_us"] > 0 and r["device_idle_share"] is None
        assert r["overlap_formulation"] == (arm == "overlap_true")
        assert r["backend"] == "gloo" and r["mesh_shape"] == [2, 1]
    assert len(rep["per_rank"]) == 2
    assert (tmp_path / "ab.json").exists()
