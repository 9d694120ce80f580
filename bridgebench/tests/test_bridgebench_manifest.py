"""BENCHMARK.json: names, units and lines as the contract allows them, and
every file found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell
    # to compile, 1200 s spare — within 43200 s with 24 cells
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
                assert _line(m["layer"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_is_found_by_name(bench):
    from bblib import cells

    configs = {c["name"]: c for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        cell = cells.load(ROOT, w["name"])
        assert cell.traffic["name"] == w["traffic"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
    assert used == set(configs)


def test_each_cell_reports_what_the_contract_asks(bench):
    from bblib import cells

    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = cells.load(ROOT, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got, (w["name"], m["name"])


def test_layers_are_named_in_perf_md(bench):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_four_chip_cells_are_at_most_a_quarter(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_command_names_only_files_under_paths(bench):
    for word in bench["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert word.startswith(tuple(p + "/" for p in bench["paths"]))
            assert os.path.exists(os.path.join(ROOT, word))
    assert os.path.isdir(BENCH)
