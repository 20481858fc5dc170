"""K1's launch plan (``segment_cuda.counts_plan``), checked on the CPU at
every shape the measurement's main path gives K1 (chip_smoke's point: 8
sites of 1080 x 1080, max_cells 512, the default FeatureConfig) and at edge
shapes that take each of its paths (one CTA, row tiles, clusters, column
groups): every (row, column) of the table belongs to exactly one CTA of
exactly one column group, each CTA's slice fits its shared memory, clusters
stay within Hopper's portable 8 CTAs, and a table no plan holds raises.
That the kernel counts exactly under each plan is held on the card
(``tests/test_torch_kernels_cuda.py``)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from saguaro_tpu_torch.kernels import segment_cuda as sc

from .torch_data import share_cpu_threads

share_cpu_threads()

B, N = 8, 1080 * 1080

MAIN_PATH = {
    "otsu": (256, (1,)),
    "radius coarse": (512, (130,)),
    "radius fine": (512, (64,) * 3),
    "texture": (512, (136,) * 20),
    "quantile level 1 and MAD": (512, (16,) * 5),
    "quantile levels 2-4": (512, (16,) * 25),
    "neighbour pairs": (512, (512,) * 4),
    "PercentTouching": (512, (1, 1)),
    "value counts": (256, (256,) * 2),
    "costes joint 8": (256, (256,) * 8),
    "costes joint 6": (256, (256,) * 6),
    "costes joint 4": (256, (256,) * 4),
    "costes joint 2": (256, (256,) * 2),
}

EDGE = {
    "mc 1": (1, (5, 3)),
    "q 1": (512, (7,)),
    "q 25": (512, (3,) * 25),
    "plane wider than a cluster": (1024, (1024,)),
    "planes wider than a cluster": (512, (2000, 9, 3000)),
    "shared at its limit": (512, (100,)),
    "shared just over": (512, (101,)),
    "one cluster at its limit": (512, (800,)),
    "one cluster just over": (512, (801,)),
    "int16 code limit": (2, (32768,)),
    "many labels": (40000, (1,)),
    "cluster of 6": (512, (500,)),
    "row wider than a slice": (2, (30000, 30000)),
}

# the path each edge shape takes, and its number of column groups
EDGE_PATHS = {
    "mc 1": ("shared", 1),
    "q 1": ("shared", 1),
    "q 25": ("shared", 1),
    "plane wider than a cluster": ("cluster", 3),
    "planes wider than a cluster": ("cluster", 8),
    "shared at its limit": ("shared", 1),
    "shared just over": ("tiles", 1),
    "one cluster at its limit": ("cluster", 1),
    "one cluster just over": ("cluster", 2),
    "int16 code limit": ("tiles", 1),
    "many labels": ("shared", 1),
    "cluster of 6": ("cluster", 1),
    "row wider than a slice": ("tiles", 2),
}


def _hold(plan, mc, sizes):
    offs = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offs[-1])
    owned = np.zeros((mc, total), np.int64)
    assert 1 <= plan.cluster <= sc.K1_MAX_CLUSTER
    assert plan.cluster == 1 or plan.tiles == 1
    assert plan.copies >= 1 and (plan.ways == 1 or plan.copies == 1)
    assert plan.rows * plan.ways >= mc and plan.rows * (plan.ways - 1) < mc
    assert plan.units >= 1
    for q0, q1, c0, c1 in plan.groups:
        assert 0 <= c0 < c1 <= total
        # the group's planes are those whose columns meet its columns
        meets = [q for q in range(len(sizes)) if offs[q] < c1 and offs[q + 1] > c0]
        assert list(range(q0, q1)) == meets
        # a CTA's slice fits its share of shared memory
        assert 4 * plan.rows * (c1 - c0) <= sc.K1_SLICE
        assert 4 * plan.rows * (c1 - c0) * plan.copies + 8 * len(sizes) <= plan.smem
        for r in range(plan.ways):
            owned[r * plan.rows : (r + 1) * plan.rows, c0:c1] += 1
    assert plan.smem <= 227 * 1024
    assert plan.smem + 1024 <= sc.K1_SMEM_SM
    assert (owned == 1).all()


@pytest.mark.parametrize("name", list(MAIN_PATH) + list(EDGE))
def test_plan_owns_every_bin_once_and_fits(name):
    mc, sizes = {**MAIN_PATH, **EDGE}[name]
    plan = sc.counts_plan(mc, sizes, B, N)
    _hold(plan, mc, sizes)
    assert plan.cluster <= sc.K1_MAX_CLUSTER <= 16
    assert plan == sc.counts_plan(mc, sizes, B, N)  # a pure function of its arguments
    table = 4 * mc * sum(sizes)
    if table <= sc.K1_SLICE:
        assert plan.path == "shared" and len(plan.groups) == 1
    if plan.path == "cluster" and table <= sc.K1_MAX_CLUSTER * sc.K1_SLICE:
        assert len(plan.groups) == 1  # one cluster holds it whole
    if plan.path == "tiles" and 4 * sum(sizes) <= sc.K1_SLICE:
        assert len(plan.groups) == 1  # a slice holds a whole row


@pytest.mark.parametrize("name", list(EDGE_PATHS))
def test_plan_path_at_edge_shapes(name):
    """The rule picks each path at the shapes the card tests use to reach
    it: one CTA up to K1_SLICE, row tiles while they number at most
    K1_CLUSTER_RATIO a plane, else the smallest cluster that holds the
    table, else clusters of K1_MAX_CLUSTER over column groups."""
    mc, sizes = EDGE[name]
    plan = sc.counts_plan(mc, sizes, B, N)
    assert (plan.path, len(plan.groups)) == EDGE_PATHS[name], plan
    if name == "cluster of 6":
        assert plan.cluster == 6


def test_plan_paths_at_the_main_path():
    plans = {k: sc.counts_plan(mc, s, B, N) for k, (mc, s) in MAIN_PATH.items()}
    assert plans["otsu"].copies == sc.K1_THREADS // 32  # a 1 KB table: one copy a warp
    for k in ("otsu", "quantile level 1 and MAD", "PercentTouching"):
        assert plans[k].path == "shared"
    # the rule: row tiles, but a cluster where tiles would exceed
    # K1_CLUSTER_RATIO a plane (neighbour pairs: 21 tiles for 4 planes)
    assert plans["neighbour pairs"].path == "cluster"
    assert plans["neighbour pairs"].cluster == sc.K1_MAX_CLUSTER
    # whole planes stay whole where they fit a group
    assert [(c0, c1) for _, _, c0, c1 in plans["neighbour pairs"].groups] == [
        (512 * q, 512 * (q + 1)) for q in range(4)]
    for k in set(MAIN_PATH) - {"otsu", "quantile level 1 and MAD", "PercentTouching",
                               "neighbour pairs"}:
        assert plans[k].path == "tiles" and plans[k].ways > 1
    # about K1_WAVES waves of resident CTAs: units x groups x ways x sites
    per_sm = sc.K1_THREADS_SM // sc.K1_THREADS
    for p in plans.values():
        assert p.units * len(p.groups) * p.ways * B <= sc.K1_WAVES * per_sm * sc.K1_SMS or p.units == 1


def test_plan_units_follow_the_pixel_count():
    small = sc.counts_plan(256, (1,), 1, 1000)
    assert small.units == 1
    big = sc.counts_plan(256, (1,), 1, N)
    assert big.units > 1


@pytest.mark.parametrize(
    "args",
    [
        (2**31, (1,)),               # keys beyond int32 at one column
        (70000, (32768,)),           # keys beyond int32
        (0, (4,)),                   # no label
        (16, ()),                    # no plane
        (16, (4, 0)),                # an empty plane
    ],
)
def test_plan_raises_rather_than_an_impossible_launch(args):
    with pytest.raises(ValueError):
        sc.counts_plan(*args, B, N)


def test_plan_raises_for_rows_beyond_one_cluster():
    # 10**6 label rows over 8 CTAs exceed a slice even at one column
    with pytest.raises(ValueError, match="label rows"):
        sc.counts_plan(10**6, (1,), B, N)


def _c_params(source: str, name: str) -> list[str]:
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [" ".join(a.split()) for a in m.group(1).split(",")]


def test_bindings_match_the_sources():
    """Every C entry point's ctypes argument list (``SIGNATURES``) matches
    the parameter list in ``csrc/*.cu``: a pointer for each pointer, a long
    long for each long long, an int for each int."""
    source = "\n".join(p.read_text() for p in (Path(sc.__file__).resolve().parents[1] / "csrc").glob("*.cu"))
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    for name, args in sc.SIGNATURES.items():
        params = _c_params(source, name)
        want = ["pointer" if "*" in a else "long long" if a.startswith("long long") else "int"
                for a in params]
        assert [kinds[a] for a in args] == want, (name, params)
