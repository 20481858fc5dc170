"""The program's recorder (``utils/timing.py``): ``StageTimer``'s stage API
and summary rows as they were; spans that nest with their parent and self
time, and the launches a block adds; wait records named after the innermost open span; nothing
kept without an active recorder, and the same outputs bit for bit with one;
and the fixpoint loops' ``rounds/<loop>`` and ``waits/<loop>`` equal to the
sweeps and reads they ran. The card test (marker ``cuda``) places the
device markers on the host clock:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import logging
import time

import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu_torch.kernels import morphology, radial
from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site_batch
from saguaro_tpu_torch.utils import timing
from saguaro_tpu_torch.utils.timing import StageTimer

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()


def test_stage_timer_api_and_summary_rows():
    t = StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    assert dict(t.count) == {"a": 2, "b": 1} and set(t.total) == {"a", "b"}
    lines = t.summary().split("\n")
    assert lines[0] == "stage timings:" and len(lines) == 3
    for line in lines[1:]:
        name = line.split()[0]
        tot, c = t.total[name], t.count[name]
        assert line == f"  {name:<30s} {tot:8.2f}s total  {tot / max(c, 1):8.3f}s/call  x{c}"
    assert not t.rows and not t.counters


def test_is_recording_only_while_a_recorder_is_active():
    assert not timing.is_recording()
    rec = StageTimer()
    with rec.recording("cpu"):
        assert timing.is_recording()
    assert not timing.is_recording()


def test_log_summary_logs_the_summary(caplog):
    t = StageTimer()
    with t.stage("read"):
        pass
    with caplog.at_level(logging.INFO, logger="saguaro_tpu_torch.timing"):
        t.log_summary()
    assert caplog.records[-1].getMessage() == t.summary()


def test_spans_nest_with_parent_and_self_time():
    rec = StageTimer()
    launches = {"k1": 5, "k2": 1}
    with rec.recording("cpu", launches=launches):
        launches["k1"] += 3
        with timing.span("outer"):
            with timing.span("inner"):
                time.sleep(0.002)
                assert timing.flag(torch.tensor([False, True]), "loop")
            with timing.trace_annotation("other"):
                timing.count("rounds/loop", 4)
            with rec.stage("staged"):
                pass
    names = [(r.name, r.parent, r.kind) for r in rec.rows]
    assert names == [("outer", None, "span"), ("inner", 0, "span"),
                     ("inner/wait", 1, "wait"), ("other", 0, "span"),
                     ("staged", 0, "span")]
    assert all(r.t0 <= r.t1 and r.d0 is None for r in rec.rows)
    tab = rec.span_table()
    out, inner = rec.rows[0], rec.rows[1]
    kids = sum(r.t1 - r.t0 for r in rec.rows if r.parent == 0)
    assert tab["outer"]["self_s"] == (out.t1 - out.t0 - kids) / 1e9
    wait = rec.rows[2]
    assert tab["inner"]["self_s"] == (inner.t1 - inner.t0 - (wait.t1 - wait.t0)) / 1e9
    assert tab["inner"]["host_s"] >= 0.002 and tab["outer"]["device_s"] == 0.0
    assert dict(rec.counters) == {"rounds/loop": 4, "waits/loop": 1, "launches/k1": 3}
    assert rec.wait_s["waits/loop"] == (wait.t1 - wait.t0) / 1e9
    assert rec.count["staged"] == 1
    summary = rec.summary()
    assert "inner/wait" in summary and "rounds/loop" in summary


def test_wait_records_in_a_profiler_trace():
    """Spans and waits are ops of a torch.profiler trace, each wait named
    after the span it blocks in and lying inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("measure/granularity"):
            timing.flag(torch.ones(3) > 0, "reconstruct")
        timing.fetch(torch.ones(2), "outside")
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()
          if e.name() in ("measure/granularity", "measure/granularity/wait", "wait")}
    assert set(ev) == {"measure/granularity", "measure/granularity/wait", "wait"}
    fam, wait = ev["measure/granularity"], ev["measure/granularity/wait"]
    assert fam.start_ns() <= wait.start_ns() <= wait.end_ns() <= fam.end_ns()


def _measure():
    img, lab = blob_sites(n_sites=1, h=48, w=52, n_ch=2, n_cells=5, seed=3)
    cfg = FeatureConfig(channels=("DNA", "GFP"), max_cells=16, granularity_length=3)
    return measure_site_batch(img.astype(np.uint16), lab, cfg, device="cpu")


def _race():
    _, lab = blob_sites(n_sites=2, h=40, w=44, n_ch=1, n_cells=6, seed=11)
    seeds = np.zeros_like(lab)
    for s in range(len(lab)):
        for k in np.unique(lab[s][lab[s] > 0]):
            ys, xs = np.nonzero(lab[s] == k)
            seeds[s, ys[len(ys) // 2], xs[len(xs) // 2]] = k
    return radial.center_race_scan(torch.from_numpy(lab), torch.from_numpy(seeds))


@pytest.mark.parametrize("case", ["measure_site_batch", "center_race_scan"])
def test_off_keeps_nothing_and_on_changes_no_output(case):
    run = _measure if case == "measure_site_batch" else _race
    idle = StageTimer()
    off = run()
    assert timing._active is None and not idle.rows and not idle.counters
    assert timing._open_spans() == []
    rec = StageTimer()
    with rec.recording("cpu"):
        on = run()
    assert timing._open_spans() == []
    if case == "measure_site_batch":
        for a, b in zip(off, on):
            assert a.keys() == b.keys()
            for name in a:
                pd.testing.assert_frame_equal(a[name], b[name], check_exact=True)
        names = {r.name for r in rec.rows}
        for fam in ("objects", "edt_radius", "center_race", "fused", "convex", "neighbors",
                    "pixel_ranges", "texture", "quantiles", "colocalization", "granularity"):
            assert f"measure/{fam}" in names
        assert {"features/dispatch", "features/finalize", "features/tables",
                "measure/granularity/wait", "measure/center_race/wait"} <= names
        by_idx = {i: r.name for i, r in enumerate(rec.rows)}
        for r in rec.rows:
            if r.name.startswith("measure/") and r.kind == "span":
                assert by_idx[r.parent] == "features/dispatch"
        assert rec.counters["waits/reconstruct"] > 0 and rec.counters["waits/costes"] == 4 * 3
    else:
        for a, b in zip(off, on):
            assert torch.equal(a, b)
        assert rec.counters["rounds/center_race_scan"] >= 1


@pytest.mark.parametrize("loop", ["reconstruct", "center_race_scan"])
def test_rounds_and_waits_count_what_the_loop_ran(loop, monkeypatch):
    ran = {"sweeps": 0, "families": 0, "settle": 0}
    if loop == "reconstruct":
        cross = morphology._cross

        def counting_cross(x, op):
            ran["sweeps"] += op == "max"
            return cross(x, op)

        monkeypatch.setattr(morphology, "_cross", counting_cross)
        img, _ = blob_sites(n_sites=2, h=40, w=44, n_ch=1, n_cells=6, seed=4)
        ceiling = torch.from_numpy(img[..., 0])
        seed = morphology._cross(morphology._cross(ceiling, "min"), "min")
        ran["sweeps"] = 0
        rec = StageTimer()
        with rec.recording("cpu"):
            morphology._reconstruct_cross_unit(seed, ceiling, check_every=4)
        assert ran["sweeps"] > 4
        assert rec.counters["rounds/reconstruct"] == ran["sweeps"]
        assert rec.counters["waits/reconstruct"] == ran["sweeps"] // 4
    else:
        relax, sweep = radial._relax_family, radial._sweep

        def counting_relax(*a):
            ran["families"] += 1
            return relax(*a)

        def counting_sweep(*a):
            ran["settle"] += 1
            return sweep(*a)

        monkeypatch.setattr(radial, "_relax_family", counting_relax)
        monkeypatch.setattr(radial, "_sweep", counting_sweep)
        rec = StageTimer()
        with rec.recording("cpu"):
            _race()
        assert ran["families"] % 4 == 0 and ran["settle"] >= 1
        assert rec.counters["rounds/center_race_scan"] == ran["families"] // 4
        assert rec.counters["waits/center_race_scan"] == ran["families"] // 4
        assert rec.counters["rounds/center_race_scan.settle"] == ran["settle"]
        assert rec.counters["waits/center_race_scan.settle"] == ran["settle"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device markers exist only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_markers_on_the_host_clock(cuda):
    """Each span's device interval lies on the host clock after its host
    enter, a child's inside its parent's, and a span that only enqueues
    long kernels ends on the device after it ends on the host."""
    a = torch.randn(4096, 4096, device=cuda)
    a @ a
    torch.cuda.synchronize()
    rec = StageTimer()
    with rec.recording(cuda):
        with timing.span("outer"):
            with timing.span("inner"):
                for _ in range(8):
                    a = (a @ a).clamp(-1, 1)
            timing.flag(a > 0, "loop")
    out, inner = rec.rows[0], rec.rows[1]
    assert out.d0 is not None and inner.d0 is not None
    assert out.t0 <= out.d0 + 1e5 and inner.t0 <= inner.d0 + 1e5
    assert out.d0 <= inner.d0 <= inner.d1 <= out.d1
    assert inner.d1 <= out.t1 + 1e5  # the wait inside outer waited for inner's work
    assert inner.d1 - inner.d0 > inner.t1 - inner.t0 and inner.d1 > inner.t1
    assert rec.span_table()["inner"]["device_s"] == (inner.d1 - inner.d0) / 1e9
