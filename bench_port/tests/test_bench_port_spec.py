"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
a cell's pieces by name, also those added as files only."""

import json
import re

import pytest

from bench_port import spec

from conftest import (HERE, ROOT, TINY_CONFIG, TINY_EXH, TINY_GENERATOR,
                      TINY_METRIC, TINY_MIXED, TINY_SEQ)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_and_entry_keys(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_texts_use_allowed_characters(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer") and key != "source":
                    assert TEXT.match(e[key]), (e["name"], key)
    for c in bench["configs"]:
        assert TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for g in ("configs", "workloads"):
        ns = [n for gg, n in names if gg == g]
        assert len(ns) == len(set(ns))
    assert all(TEXT.match(w) for w in bench["command"])
    assert len(bench["command"]) <= 32


def test_every_cell_reports_setup_a_rate_and_a_layer_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert (HERE / "generators"
                / f"{cell.params['generator']}.py").exists()
        for m in cell.per_layer:
            assert m["moves"] in names
            assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_paths_hold_the_files_the_benchmark_names(bench):
    assert bench["paths"] == ["bench_port"]
    for c in bench["configs"]:
        assert c["file"].startswith("bench_port/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_files_added_alone_are_found(tiny):
    """A configuration, cells, a mix, a generator and a metric added as
    files (and entries) only: the harness finds each by its name."""
    seq, exh = tiny.cell(TINY_SEQ), tiny.cell(TINY_EXH)
    assert seq.config["name"] == exh.config["name"] == TINY_CONFIG
    assert seq.params["overlap"] == 3 and seq.params["views"] == 8
    assert seq.params["in_flight"] == 2          # from traffic/sequential
    assert exh.params["num_sets"] == 6
    assert TINY_METRIC in {m["name"] for m in seq.per_layer}
    assert TINY_METRIC not in {m["name"] for m in exh.per_layer}
    assert "frames_per_s" in {m["name"] for m in seq.end_to_end}
    assert "match_pairs_per_s" in {m["name"] for m in exh.end_to_end}
    mixed = tiny.cell(TINY_MIXED)
    assert mixed.params["generator"] == TINY_GENERATOR
    assert spec.stream_class(mixed).__module__ != \
        spec.stream_class(exh).__module__
    assert spec.stream_class(mixed).__name__ == "Stream"

    class Ctx:
        units = 2
    assert spec.metric_reader(TINY_METRIC, tiny.home)(Ctx()) == 2.0


def test_a_cell_file_that_disagrees_with_the_benchmark_is_refused(tiny):
    for w in tiny.bench["workloads"]:
        if w["name"] == TINY_SEQ:
            w["traffic"] = "exhaustive"
    with pytest.raises(ValueError):
        tiny.cell(TINY_SEQ)
