"""BENCHMARK.json and the files it names: the contract's shapes, and that a
new configuration, traffic mix or metric is found by name alone."""
import json
import re
import shutil

import pytest

from h100bench_util import ROOT, TINY, tiny_root

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(one_line(w) for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names(group):
    names = [e["name"] for e in MAN[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert one_line(c["why"])
        assert PATH.match(c["file"]) and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert body["guarantee"] and body["check"]["residual_limit"] == \
            body["tol"]


def test_cells():
    pairs = set()
    four = 0
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    for m in MAN[group]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        mod = harness.reader(m["name"])
        assert callable(mod.read)
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert one_line(m["layer"])
            assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    if group == "end_to_end":
        assert any(m["name"] == "setup_s" for m in MAN[group])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_enough(name):
    e2e = {m["name"] for m in harness.metric_names(MAN, name, False)}
    layer = harness.metric_names(MAN, name, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


def test_layers_named_in_perf():
    perf = (ROOT / "PERF.md").read_text()
    for m in MAN["per_layer"]:
        assert m["layer"] in perf


def test_a_new_cell_config_traffic_and_metric_are_found(tmp_path):
    """Files dropped beside the others, and entries added to the manifest,
    are all a new cell needs: no file of the benchmark is edited."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    traffic = json.loads(
        (root / "benchmark/traffic/smooth4.json").read_text())
    traffic["sources"] = traffic["sources"][:2]
    (root / "benchmark/traffic/smooth2.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/solves_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.solves))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny2", "config": "tiny",
                             "traffic": "smooth2", "chips": 1, "why": "t"})
    man["end_to_end"].append({"name": "solves_done", "unit": "count",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock", "workloads": ["tiny2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert p.read_bytes() == data
    wl, config, tr = harness.cell(man, "tiny2", root)
    assert config["name"] == "tiny" and len(tr["sources"]) == 2
    names = [m["name"] for m in harness.metric_names(man, "tiny2", False)]
    assert "solves_done" in names
    assert "solves_done" not in [
        m["name"] for m in harness.metric_names(man, TINY, False)]
    import time

    import torch
    out = harness.run(man, "tiny2", 5, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), root=root)
    assert out["metrics"]["solves_done"]["value"] == out["attempted"]
    shutil.rmtree(root / "benchmark")
