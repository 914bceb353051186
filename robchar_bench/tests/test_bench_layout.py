"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import os
import re

import pytest

from robchar_bench import harness

BENCH = harness.load_json(harness.bench_path())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["robchar_bench"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(harness.bench_path()) <= 64 * 1024
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("robchar_bench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    spec = harness.cell_spec(BENCH, cell)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    declared = spec["mix"]["end_to_end"]
    assert names - {"setup_s"} == set(declared)
    for d in declared.values():
        assert set(d) <= {"work", "scale"}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for fn in ("setup", "warm", "unit", "work", "valid", "readings"):
        assert callable(getattr(spec["driver"], fn))
    assert spec["limits"], f"{cell} has no limits file"
    for name, lim in spec["limits"].items():
        assert lim["lower"] < lim["limit"] < lim["upper"], name


#: the precisions a configuration may state (TF32 off in both); the
#: drivers' controls follow them (drivers/mc.CONTROLS)
DTYPES = ("float32", "float64")


def _states_its_problem(entry, cfg):
    """Assert that configuration file ``cfg`` states the problem of its
    BENCHMARK.json entry ``entry``."""
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["dtype"] in DTYPES and cfg["tf32"] is False
    assert 0 <= cfg["in_site"] < cfg["n"] and \
        0 <= cfg["out_site"] < cfg["n"]
    assert len(cfg["mc"]["noise_levels"]) == 11
    assert cfg["mc"]["bootreps"] == 100


def test_configs_state_their_problem():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        _states_its_problem(
            c, harness.load_json(os.path.join(harness.ROOT, c["file"])))


def _made_up(**changes):
    entry = BENCH["configs"][0]
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    return entry, {**cfg, **changes}


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_configuration_of_either_dtype_is_admitted(dtype):
    _states_its_problem(*_made_up(dtype=dtype, tf32=False))


@pytest.mark.parametrize("changes", [
    {"dtype": "float16"}, {"dtype": "bfloat16"}, {"dtype": "complex128"},
    {"dtype": "float64", "tf32": True}, {"dtype": "float32", "tf32": True},
    {"tf32": None}], ids=str)
def test_a_made_up_configuration_is_refused(changes):
    with pytest.raises(AssertionError):
        _states_its_problem(*_made_up(**changes))


def test_files_under_paths_are_named_from_names():
    for dirpath, _, files in os.walk(harness.PACKAGE):
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_benchmark_json_is_plain_json():
    with open(harness.bench_path()) as f:
        json.loads(f.read())
