"""The readers of the program's wait records and family ranges, on
synthetic runs: an idle gap that opens inside ``measure/granularity/wait``
is charged to the wait, one that opens in the bare family range is not;
waits and their host seconds are counted a site measured; a family's device
seconds are those of the activities launched in its range, the benchmark's
own pixel counts left out; a trace without wait records (a program that
keeps none) reads as nothing. The breakdown names both kinds of gap apart, and
``trace.read`` keeps a wait record nested in its family range."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hcs_bench import trace as trace_mod
from hcs_bench.records import Run

BENCH = Path(__file__).resolve().parents[1]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


IDLE = reader("device.idle_in_wait_s_per_site.features")
WAITS = reader("measure.waits_per_site")
WAIT_S = reader("measure.wait_s_per_site")
FAMILY = {fam: reader(f"measure.{fam}.s_per_site") for fam in ("granularity", "center_race")}

# host ranges (ns): a dispatch whose granularity and centre race each block once
RANGES = [(0, 1000, "bench/measure.dispatch"), (100, 900, "measure/granularity"),
          (500, 600, "measure/granularity/wait"), (920, 980, "measure/center_race"),
          (955, 975, "measure/center_race/wait")]
# device busy: a gap 200-250 and one 700-800 open in the bare family range;
# 510-620 opens in the wait; 960-970 in the centre race's wait
KERNELS = [(100, 200), (250, 510), (620, 700), (800, 960), (970, 990)]
# the first four launched in the granularity range, the last in the race's
KERNEL_RANGES = [("bench/measure.dispatch", "measure/granularity")] * 4 + [
    ("bench/measure.dispatch", "measure/center_race")]


def make_trace(ranges=RANGES, kernels=KERNELS, kernel_ranges=None) -> trace_mod.Trace:
    if kernel_ranges is None:
        kernel_ranges = (KERNEL_RANGES * len(kernels))[: len(kernels)]
    return trace_mod.Trace(window_s=1e-6, kernels=np.array(kernels, dtype=np.float64).reshape(-1, 2),
                           kernel_names=["k"] * len(kernels), kernel_ops=["aten::add"] * len(kernels),
                           kernel_ranges=list(kernel_ranges), ranges=list(ranges))


def make_run(tr, dispatches=1, sites_per_batch=2) -> Run:
    return Run(traffic={"sites_per_batch": sites_per_batch}, sites=8, spans={}, span_s=1.0, trace=tr,
               traced_calls={"segment": dispatches, "measure.dispatch": dispatches})


def test_idle_in_wait_charges_only_gaps_opening_in_a_wait():
    assert IDLE(make_run(make_trace())) == pytest.approx((110 + 10) * 1e-9 / 2)


def test_waits_per_site_counts_the_wait_records():
    assert WAITS(make_run(make_trace())) == 2 / 2
    assert WAITS(make_run(make_trace(), dispatches=2, sites_per_batch=4)) == 2 / 8


def test_wait_s_per_site_sums_the_wait_records():
    assert WAIT_S(make_run(make_trace())) == pytest.approx((100 + 20) * 1e-9 / 2)
    assert WAIT_S(make_run(make_trace(), dispatches=2, sites_per_batch=4)) == pytest.approx(120e-9 / 8)


@pytest.mark.parametrize("fam,ns", [("granularity", 100 + 260 + 80 + 160), ("center_race", 20)])
def test_family_device_seconds_of_what_it_launched(fam, ns):
    assert FAMILY[fam](make_run(make_trace())) == pytest.approx(ns * 1e-9 / 2)
    counted = make_trace(kernels=KERNELS + [(992, 999)], kernel_ranges=KERNEL_RANGES + [
        ("bench/measure.dispatch", f"measure/{fam}", "bench/roofline_count")])
    assert FAMILY[fam](make_run(counted)) == pytest.approx(ns * 1e-9 / 2)


@pytest.mark.parametrize("fam", ["granularity", "center_race"])
def test_family_device_seconds_nothing_to_read(fam):
    read = FAMILY[fam]
    assert read(make_run(None)) is None
    assert read(make_run(make_trace(), dispatches=0)) is None
    assert read(make_run(make_trace(kernel_ranges=[("bench/segment",)] * len(KERNELS)))) is None


@pytest.mark.parametrize("read", [IDLE, WAITS, WAIT_S], ids=["idle_in_wait", "waits", "wait_s"])
def test_nothing_to_read(read):
    bare = [r for r in RANGES if not r[2].endswith("/wait")]
    assert read(make_run(make_trace(ranges=bare))) is None
    assert read(make_run(None)) is None
    assert read(make_run(make_trace(), dispatches=0)) is None


def test_idle_in_wait_with_one_busy_interval():
    assert IDLE(make_run(make_trace(kernels=[(0, 1000)]))) == 0.0


def test_breakdown_names_wait_gaps_apart_from_family_gaps():
    gaps = dict(trace_mod.breakdown(make_trace())["idle_gaps"])
    assert gaps["measure/granularity/wait"] == pytest.approx(110e-9)
    assert gaps["measure/granularity"] == pytest.approx(150e-9)
    assert gaps["measure/center_race/wait"] == pytest.approx(10e-9)


def test_trace_read_keeps_a_wait_record_inside_its_family():
    """The program's records are ``_RecordFunctionFast`` ops; the trace's
    host ranges keep both, nested, and the readers find the wait."""
    from torch.profiler import ProfilerActivity, profile

    rec = torch._C._profiler._RecordFunctionFast
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec("measure/granularity"):
            x = torch.ones(8).sum()
            with rec("measure/granularity/wait"):
                bool(x)
    tr = trace_mod.read(prof, 1.0)
    names = {n: (a, b) for a, b, n in tr.ranges}
    fam, wait = names["measure/granularity"], names["measure/granularity/wait"]
    assert fam[0] <= wait[0] <= wait[1] <= fam[1]
    assert WAITS(make_run(tr, sites_per_batch=1)) == 1.0
