"""The readings the check's limits are set from, on the card, at the cell's
own size.

    python3 hcs_bench/calibrate.py --workload <cell> --seeds a,b,c,... --control 3

For each seed: the cell's inputs and weights as a run makes them, one batch
(the run's sampled batch for that seed) through the timed path's calls, and
the check's numbers of the program against the reference; for the first
``--control`` seeds also the control's (the reference in the next lower
precision, in the program's place). Prints one JSON line a seed, with
the worst table columns or the embedding gaps' quantiles.
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

    from hcs_bench import program
    from hcs_bench.compare import Side, numbers
    from hcs_bench.traffic.generator import seed_sequence

    cfg = spec["config"]
    t0 = time.perf_counter()
    batches, cp_state, ef_state = bench.inputs_and_weights(spec, seed, device)
    k = int(seed_sequence(seed, 1).integers(0, bench.SAMPLE_BATCHES)) % len(batches)
    images = batches[k]
    engine = program.build_engine(cfg, cp_state, ef_state, device)
    if cfg["pipeline"] == "features":
        fcfg = program.feature_config(cfg)
        lab = torch.stack(engine.segment_batch(images))
        labels = lab.cpu().numpy()
        outputs = program.measure_site_batch_finalize(
            program.measure_site_batch_dispatch(images, lab, fcfg, device=engine.device))
    else:
        seen = {}
        segment = engine.segment_batch

        def keep(x):
            seen["labels"] = segment(x)
            return seen["labels"]

        engine.segment_batch = keep
        res = engine.process_site_batch(list(range(len(images))), images)
        outputs = [res.get(i) for i in range(len(images))]
        labels = torch.stack(seen["labels"]).cpu().numpy()
    del engine
    torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t0
    ref = Side(cfg, cp_state, ef_state, device)
    cache, detail = {}, {}
    out = {"seed": seed, "batch": k, "program": numbers(cfg, images, labels, outputs, ref, seed,
                                                          detail=detail, cache=cache)}
    out["detail_program"] = summarize(detail)
    if control:
        low = Side(cfg, cp_state, ef_state, device, lower=True)
        detail = {}
        out["control"] = numbers(cfg, images, low.labels(images), None, ref, seed, control=low,
                                 detail=detail, cache=cache)
        out["detail_control"] = summarize(detail)
    out["seconds"] = {"program": t_prog, "total": time.perf_counter() - t0}
    return out


def summarize(detail: dict) -> dict:
    import numpy as np

    if "columns" in detail:
        out = {}
        for key in ("columns", "own_columns"):
            cols = detail[key]
            worst = sorted(cols.items(), key=lambda kv: -kv[1])[:12]
            out[key] = {"worst": [[f"{t}:{c}", v] for (t, c), v in worst],
                        "with_off_rows": sum(v > 0 for v in cols.values()), "of": len(cols)}
        return out
    g = detail.get("gaps", np.zeros(0))
    return {"gap_quantiles": [float(q) for q in np.quantile(g, [0, 0.5, 0.9, 0.99, 1.0])] if len(g) else []}


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
