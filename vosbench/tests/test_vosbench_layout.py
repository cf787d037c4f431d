"""BENCHMARK.json against the contract's shape, and every file of every cell,
configuration and metric found by name."""

import json
import math
import re

import pytest

from vosbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("keydim", "valdim", "mdim", "topl", "max_objs")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "vosbench/run.py"]
    assert BENCH["paths"] == ["vosbench"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vosbench/") and len(c["why"]) <= 200
        assert len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_files_are_found_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.driver(cell).OPS is not None
        assert cell.limits, f"{w['name']}: no limits in vosbench/workloads/{w['name']}.json"
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_keep_the_published_widths(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert conf["reduced"] == cfg["reduced"] == []
    assert cfg["source"] == conf["source"]
    published = dict(backbone="resnet50", keydim=128, valdim=512, num_bases=128, num_em_iters=4,
                     em_tau=0.05, topl=64, max_objs=2, mdim=256)
    assert {k: cfg[k] for k in published} == published
    assert math.isclose(cfg["em_tau"], 0.05)
