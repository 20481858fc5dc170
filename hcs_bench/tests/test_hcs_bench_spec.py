"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name under ``hcs_bench/``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "hcs_bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["command"] == ["python3", "hcs_bench/run.py"]
    assert SPEC["paths"] == ["hcs_bench"]
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each allowed rs + 60 s,
    # 2 x 90 s of compilation a cell and 1200 s spare, within 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_text_fields(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("hcs_bench/")
    body = json.loads(path.read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert (BENCH / "pipelines" / f"{body['pipeline']}.py").is_file()
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_names_its_plugins(config):
    """The pipeline and each network a configuration names are files under
    ``pipelines/`` and ``networks/``; each network's section names the
    program's config class by a dotted path into the port."""
    body = json.loads((ROOT / config["file"]).read_text())
    assert NAME.match(body["pipeline"]) and (BENCH / "pipelines" / f"{body['pipeline']}.py").is_file()
    assert "segmenter" in body
    for role in ("segmenter", "embedder"):
        if role in body:
            assert NAME.match(body[role]) and (BENCH / "networks" / f"{body[role]}.py").is_file()
            net = importlib.import_module(f"hcs_bench.networks.{body[role]}")
            assert body[net.SECTION]["class"].startswith("saguaro_tpu_torch.")
    for key, section in body.items():
        if isinstance(section, dict) and "class" in section:
            assert re.match(r"^saguaro_tpu_torch(\.[A-Za-z_][A-Za-z0-9_]*)+$", section["class"]), key


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert "labels_px_off" in limits and len(limits) >= 2
    assert any(c["name"] == cell["config"] for c in SPEC["configs"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in SPEC["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
        assert "workloads" in metric
        if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
            assert metric["name"].endswith("_roofline") or "mfu" in metric["name"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    path = BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    # a per-layer metric's cells report the end-to-end metric it moves
    for m in SPEC["per_layer"]:
        if cell in m["workloads"]:
            assert m["moves"] in e2e


def test_setup_bound_and_chips():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_layer_names_consistent():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf


def pipeline_of(cell: dict) -> str:
    conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    return json.loads((ROOT / conf["file"]).read_text())["pipeline"]


@pytest.mark.parametrize("cell", [w for w in SPEC["workloads"] if pipeline_of(w) == "job"],
                         ids=lambda c: c["name"])
def test_job_traffic_makes_whole_jobs(cell):
    """A cell of the ``job`` pipeline: its traffic's sites are one job of
    its configuration's ``job_sites``, with a timepoint; its batches are the
    engine's site batches."""
    body = json.loads((ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == cell["config"])).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["distinct_batches"] * traffic["sites_per_batch"] == body["job_sites"]
    assert isinstance(traffic["timepoint"], str)
    assert traffic["sites_per_batch"] == body["engine"]["site_batch"]
