"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each name finds, and the chip time of a full check."""

import json
import math
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"][1].startswith("benchmark/")
    assert 1 <= spec["run_seconds"] <= 51


def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w["traffic"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entries_have_only_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e


def test_every_name_finds_its_files(spec):
    cfgs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        c = cfgs[w["config"]]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        for kind, ext in (("reference", "py"), ("work", "py")):
            assert os.path.exists(os.path.join(HERE, kind,
                                               f"{c['name']}.{ext}"))
        # every configuration names its driver: no default
        assert NAME.match(body["driver"]), body["driver"]
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           f"{body['driver']}.py"))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py"))


def test_a_full_check_of_24_cells_fits(spec):
    runs = 2 + 14 * 24
    total = runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert math.isfinite(total)


# an import of the CLI module itself, not of ``cli_directional``
CLI_IMPORT = re.compile(
    r"^\s*(from\s+gsn_tpu_torch\.cli\b|import\s+gsn_tpu_torch\.cli\b"
    r"|from\s+gsn_tpu_torch\s+import\s+.*\bcli\b)", re.M)


def test_one_file_imports_the_cli():
    """Nothing of the harness outside ``drivers/gsn_cli.py`` imports
    ``gsn_tpu_torch.cli``."""
    found = []
    for folder, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                with open(path) as f:
                    if CLI_IMPORT.search(f.read()):
                        found.append(os.path.relpath(path, HERE))
    assert found == [os.path.join("drivers", "gsn_cli.py")]


@pytest.mark.parametrize("name", ["program", "cell", "compare", "readings"])
def test_the_core_knows_no_cli(name):
    """The generic core names no CLI flag and no model field: both are
    the driver's."""
    with open(os.path.join(HERE, "core", f"{name}.py")) as f:
        text = f.read()
    assert "d_in_id" not in text
    assert not re.search(r"[\"']--[a-z]", text), name
