"""A benchmark cell's synced stretch with the program's recorder open or
not: what the spans, waits and counters inside ``saguaro_tpu_torch`` read
outside the profiler, and what opening the recorder costs.

    python3 tools/recorder_window.py --workload features.confluent81 \\
        --seed 3300000201 --seconds 51 --modes off,on,on,off

Builds the cell with ``hcs_bench/run.py``'s own functions (inputs and
weights from the seed, the engine, one warm batch), then runs, once for each
mode, ``hcs_bench/program.py``'s window with every benchmark span ending in
a device sync, the stretch a traced run reads its span metrics from. Mode
``on`` opens a ``StageTimer().recording(device, launches=...)`` around the
window; ``off`` does not. One JSON line a window on standard output: the
benchmark's span seconds a site, and with the recorder, per span and wait
name its calls and host, device and self seconds a site and every counter a
site (``rounds/<loop>``, ``waits/<loop>``, ``launches/<kernel>``); the
recorder's summary goes to standard error. Runs on one NVIDIA GPU; the
card's name and power limit are in each line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hcs_bench import program  # noqa: E402
from hcs_bench.run import card, inputs_and_weights, load_cell  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda  # noqa: E402
from saguaro_tpu_torch.utils.timing import StageTimer  # noqa: E402


def window(engine, fcfg, batches: list, seconds: float, record: bool, device) -> dict:
    """One synced window of the cell, with the recorder open or not."""
    rec = StageTimer() if record else None
    with rec.recording(device, launches=segment_cuda.LAUNCHES) if record else contextlib.nullcontext():
        if fcfg is not None:
            w = program.features_window(engine, fcfg, batches, seconds, 0, synced=True)
        else:
            w = program.embed_window(engine, batches, seconds, 0, synced=True)
    sites = w.span_sites
    out = {"mode": "on" if record else "off", "sites": sites, "batches": w.batches,
           "spans_s_per_site": {name: s / sites for name, s in w.spans.items()}}
    if record:
        print(rec.summary(), file=sys.stderr)
        out["recorder_per_site"] = {name: {k: v if k == "calls" else v / sites for k, v in e.items()}
                                    for name, e in rec.span_table().items()}
        out["counters_per_site"] = {name: v / sites for name, v in sorted(rec.counters.items())}
        out["wait_s_per_site"] = {name: v / sites for name, v in sorted(rec.wait_s.items())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="off,on,on,off")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recorder_window: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = load_cell(args.workload)
    batches, cp_state, ef_state = inputs_and_weights(spec, args.seed, device)
    engine = program.build_engine(spec["config"], cp_state, ef_state, device)
    pipeline = spec["config"]["pipeline"]
    fcfg = program.feature_config(spec["config"]) if pipeline == "features" else None
    program.warm(engine, fcfg, pipeline, batches[0])
    info = card()
    for mode in args.modes.split(","):
        res = window(engine, fcfg, batches, args.seconds, mode == "on", device)
        res.update(workload=args.workload, seed=args.seed, card=f"{info['kind']} ({info['smi']})")
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
