"""The readings the check's limits are set from, on the card, at the cell's
own size.

    python3 hcs_bench/calibrate.py --workload <cell> --seeds a,b,c,... --control 3

For each seed: the cell's inputs and weights as a run makes them, one batch
(the run's sampled batch for that seed) through the timed path's calls, and
the check's numbers of the program against the reference; for the first
``--control`` seeds also the control's (the reference in the next lower
precision, in the program's place). Prints one JSON line a seed, with
the pipeline's details: the worst table columns, or the quantiles of the
embedding gaps or of the sites' shares of objects off.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hcs_bench import run as bench  # noqa: E402


def one_seed(spec: dict, seed: int, control: bool, device) -> dict:
    import torch

    from hcs_bench import pipelines, program
    from hcs_bench.compare import Side, numbers
    from hcs_bench.traffic.generator import seed_sequence

    cfg = spec["config"]
    t0 = time.perf_counter()
    batches, states = bench.inputs_and_weights(spec, seed, device)
    k = int(seed_sequence(seed, 1).integers(0, bench.SAMPLE_BATCHES)) % len(batches)
    images = batches[k]
    engine = program.build_engine(cfg, states, device)
    labels, outputs = pipelines.load(cfg["pipeline"]).batch(engine, cfg, images)
    del engine
    torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t0
    ref = Side(cfg, states, device)
    cache, detail = {}, {}
    out = {"seed": seed, "batch": k, "program": numbers(cfg, images, labels, outputs, ref, seed,
                                                          detail=detail, cache=cache)}
    out["detail_program"] = summarize(detail)
    if control:
        low = Side(cfg, states, device, lower=True)
        detail = {}
        out["control"] = numbers(cfg, images, low.labels(images), None, ref, seed, control=low,
                                 detail=detail, cache=cache)
        out["detail_control"] = summarize(detail)
    out["seconds"] = {"program": t_prog, "total": time.perf_counter() - t0}
    return out


def summarize(detail: dict) -> dict:
    """The worst dozen of each set of per-column shares, and the quantiles
    of each array of readings."""
    import numpy as np

    out = {}
    for key, v in detail.items():
        if isinstance(v, dict):
            worst = sorted(v.items(), key=lambda kv: -kv[1])[:12]
            out[key] = {"worst": [[f"{t}:{c}", x] for (t, c), x in worst],
                        "with_off_rows": sum(x > 0 for x in v.values()), "of": len(v)}
        elif len(v):
            out[key] = [float(q) for q in np.quantile(v, [0, 0.5, 0.9, 0.99, 1.0])]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()
    import torch

    spec = bench.load_cell(args.workload)
    info = bench.card()
    print(json.dumps({"card": info}), flush=True)
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        print(json.dumps(one_seed(spec, s, i < args.control, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
