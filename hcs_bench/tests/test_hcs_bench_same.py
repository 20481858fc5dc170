"""Both cells at the tiny size give, for ``SEED``, the weights, the models'
FLOPs and the checked numbers that the harness gave before its networks and
pipelines became plug-ins (values recorded from that harness on the CPU,
with 4 torch threads). EfficientNetV2's BatchNorm statistics come from a
float32 pass over crops, and the embedding gap from the networks, whose
sums the thread count orders, so the test runs on 4 threads."""

from __future__ import annotations

import hashlib
import time

import pytest
import torch

from hcs_bench import run
from hcs_bench.tests.test_hcs_bench_dry import CPU, SEED
from hcs_bench.tests.tiny import tiny

CELLPOSE = "648ce7313916356d70e0367dab5fac145f4031f90a6e797b42bbb99a38d3469c"
SAME = {
    "features.confluent81": {
        "digests": {"cellpose": CELLPOSE},
        "model_flops": {"site": 31004753920},
        "checked": {"labels_px_off": 0.00272556014269109, "table_col_off": 0.0, "table_own_off": 0.0},
    },
    "embed.confluent81": {
        "digests": {"cellpose": CELLPOSE,
                    "effnet": "22f242abf202da7bc8c00ca1840b4785567e78baada02e48978755f94a51180a"},
        "model_flops": {"site": 31004753920, "crop": 2037283328.0},
        "checked": {"labels_px_off": 0.00272556014269109, "embed_cos_gap": 1.1696628360868822e-05},
    },
}


def digest(state: dict) -> str:
    """sha256 over a state dict's keys in order, each tensor's dtype, shape
    and bytes."""
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SAME))
def test_same_weights_flops_and_checked_numbers(cell, four_threads):
    spec = tiny(run.load_cell(cell))
    want = SAME[cell]
    _, states = run.inputs_and_weights(spec, SEED, CPU)
    assert {k: digest(v) for k, v in states.items()} == want["digests"]
    assert run.model_flops(spec["config"], spec["traffic"]) == want["model_flops"]
    res = run.run_cell(spec, SEED, 0.1, False, CPU, t0=time.perf_counter())
    assert {k: v["value"] for k, v in res["checked"].items()} == want["checked"]
