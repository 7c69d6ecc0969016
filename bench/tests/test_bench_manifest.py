"""The manifest, the cells' files and the metric readers agree, obey the
benchmark's naming rules, and are found by name alone."""

import json
import re
import shutil
import types

import pytest

from bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_has_exactly_the_contract_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"]
    assert M["command"][1].startswith("bench/")
    assert 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = manifest.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.workload["why"] == next(
        w["why"] for w in M["workloads"] if w["name"] == name)
    assert cell.chips == 1


def test_names_units_and_lines_follow_the_rules():
    names = [c["name"] for c in M["configs"]] + CELLS + \
        [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in M["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        for cell in m["workloads"]:
            assert m["name"] in {x["name"] for x in
                                 manifest.cell(cell).per_layer}
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_each_reader_declares_its_manifest_entry(metric):
    r = manifest.reader(metric["name"])
    assert (r.UNIT, r.BETTER, r.SOURCE) == (
        metric["unit"], metric["better"], metric["source"])
    if "layer" in metric:
        assert (r.LAYER, r.MOVES) == (metric["layer"], metric["moves"])


def test_dropped_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A new cell and a new per-layer metric are files and manifest
    entries; nothing in the harness names them."""
    bench = tmp_path / "bench"
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(manifest.BENCH / d, bench / d)
    w = json.loads((bench / "workloads" /
                    "rand100.cpu_client.json").read_text())
    w["traffic"] = "weak_client"
    w["mix"]["threads"] = [16, 16, 16, 16]
    (bench / "workloads" / "rand100.slow.json").write_text(json.dumps(w))
    (bench / "metrics" / "late_share.slow.py").write_text(
        'LAYER = "service: runtime/serve.py"\nUNIT = "%"\n'
        'BETTER = "lower"\nSOURCE = "host_clock"\n'
        'MOVES = "slow_rps"\n\n\ndef read(run):\n'
        '    return 100.0 * sum(r.done > r.due + 0.01 for r in run.reqs)'
        ' / len(run.reqs)\n')
    m = json.loads(json.dumps(M))
    m["workloads"].append({"name": "rand100.slow",
                           "config": "rand100_catalog",
                           "traffic": "weak_client", "chips": 1,
                           "why": "clients of 16 threads"})
    m["end_to_end"].append({"name": "slow_rps", "unit": "req/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["rand100.slow"]})
    m["per_layer"].append({"name": "late_share.slow", "unit": "%",
                           "better": "lower", "source": "host_clock",
                           "layer": "service: runtime/serve.py",
                           "moves": "slow_rps",
                           "workloads": ["rand100.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(manifest, "BENCH", bench)
    assert "rand100.slow" in manifest.workload_names()
    cell = manifest.cell("rand100.slow", root=tmp_path)
    assert cell.workload["mix"]["threads"] == [16, 16, 16, 16]
    assert [x["name"] for x in cell.per_layer] == ["late_share.slow"]
    assert {x["name"] for x in cell.end_to_end} == {"slow_rps", "setup_s"}
    run = types.SimpleNamespace(reqs=[types.SimpleNamespace(done=1.0, due=0.0),
                                      types.SimpleNamespace(done=1.0, due=1.0)])
    assert manifest.reader("late_share.slow").read(run) == 50.0
