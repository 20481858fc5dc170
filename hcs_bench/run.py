"""The benchmark of saguaro_tpu_torch on one NVIDIA GPU.

    python3 hcs_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: makes the cell's inputs and the
weights of the networks its configuration names (``networks/<name>.py``)
from the seed, builds the program's engine from the configuration file,
warms one batch of the cell's own shape, then drives the configuration's
pipeline (``pipelines/<name>.py``) in a closed loop of site batches for
``--seconds`` (the window closes when the batch in flight is done) and
prints one JSON line last on standard output.
With ``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` the window's first batch runs under torch.profiler, then,
with the profiler stopped, batches run for ``--seconds`` more with each
benchmark-side span ending in a sync, and its metrics are the cell's
per-layer metrics, read by ``metrics/<name>.py`` (device readings from
the profiled batch, spans from the batches after it). After the window the
program's state is freed, and the plain reference (``reference/``)
recomputes a batch of the window drawn from the seed; the numbers compared
and their limits (``limits/<cell>.json``) are the last lines on standard
error and the last key of the result line. Without a CUDA device, or with
fewer than the cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "saguaro_tpu")
TRACE_BATCHES = 1   # batches of the window under the profiler in a traced run
SAMPLE_BATCHES = 3  # the checked batch is one of the window's first three


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration and
    traffic files, its per-layer metrics and its limits."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in spec["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in spec["per_layer"] if name in m.get("workloads", [name])],
    }


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hcs_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_flops(cfg: dict, traffic: dict) -> dict:
    """The published models' FLOPs of one unit of each network's work: a
    site's segmentation and, in a cell with an embedder, a crop's embedding
    (``networks.ROLES``)."""
    from hcs_bench import networks

    return {networks.ROLES[role]: net.flops(cfg, traffic) for role, net in networks.named(cfg)}


def inputs_and_weights(spec: dict, seed: int, device) -> tuple[list, dict]:
    """A run's batches (host numpy, from the seed) and the state dicts of
    its networks (made on ``device``), by the configuration section each
    network's sizes are in."""
    from hcs_bench import networks
    from hcs_bench.traffic.generator import make_batches

    cfg, traffic = spec["config"], spec["traffic"]
    batches, nuclei = make_batches(traffic, seed)
    states = {net.SECTION: net.weights(cfg, traffic, batches, nuclei, seed, device)
              for _, net in networks.named(cfg)}
    return batches, states


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """One run of a cell on ``device``: returns the result line's fields
    (without ``device``' card fields)."""
    import torch

    from hcs_bench import pipelines, program, trace as trace_mod, yardstick
    from hcs_bench.compare import Side, numbers
    from hcs_bench.check import judge
    from hcs_bench.records import Run
    from hcs_bench.traffic.generator import seed_sequence

    cfg, traffic = spec["config"], spec["traffic"]
    pipeline = cfg["pipeline"]
    pipe = pipelines.load(pipeline)
    marks = [("start", time.perf_counter())]
    batches, states = inputs_and_weights(spec, seed, device)
    marks.append(("inputs and weights", time.perf_counter()))
    if hasattr(pipe, "prepare"):  # inputs the pipeline's window reads from disk, written in set-up
        batches = pipe.prepare(cfg, traffic, batches)
        marks.append(("input files", time.perf_counter()))
    engine = program.build_engine(cfg, states, device)
    marks.append(("engine", time.perf_counter()))
    pipe.batch(engine, cfg, batches[0])  # the warm batch: nothing builds inside the window
    program.sync(device)
    marks.append(("warm batch (and the first run's build)", time.perf_counter()))
    sample_k = int(seed_sequence(seed, 1).integers(0, SAMPLE_BATCHES))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    parts = {"imports": marks[0][1] - t0}
    parts.update({name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])})

    traced: dict = {}
    prof = recorder = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        recorder = program.KernelRecorder(yardstick.WORK)
        recorder.__enter__()
        prof.start()
        traced["t0"] = time.perf_counter()

    def stop_trace(w):
        if prof is not None and "t1" not in traced:
            program.sync(device)
            traced["t1"] = time.perf_counter()
            prof.stop()
            recorder.__exit__(None, None, None)
            traced.update(calls=dict(w.calls), crops=w.crops)
            w.start_spans(time.perf_counter())

    def after_batch(w):
        if w.batches >= TRACE_BATCHES:
            stop_trace(w)

    w = pipe.window(engine, cfg, batches, seconds, sample_k, trace, after_batch, recording=not trace)
    window_s = w.t_end - w.t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ends = [w.t_start] + w.batch_ends
    result: dict = {"attempted": w.sites, "failed": w.failed, "metrics": {}, "setup_parts": parts,
                    "batch_s": [b - a for a, b in zip(ends[:-1], ends[1:])]}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    values: dict[str, float] = {}
    if not trace:
        values = {f"{pipeline}_sites_per_s": w.sites / window_s, "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        names = [m["name"] for m in spec["end_to_end"]]
    else:
        tr = trace_mod.read(prof, traced["t1"] - traced["t0"]) if cuda else None
        run = Run(traffic=traffic, sites=w.span_sites, spans=w.spans, span_s=w.t_end - w.span_t0,
                  span_crops=w.span_crops, trace=tr, traced_calls=traced.get("calls", {}),
                  traced_crops=traced.get("crops", 0), kernel_work=recorder.totals(),
                  model_flops=model_flops(cfg, traffic))
        names = [m["name"] for m in spec["per_layer"]]
        for name in names:
            v = reader(name)(run)
            if v is not None:
                values[name] = v
        if tr is not None:
            result["busy_s"], result["trace_window_s"] = tr.busy_s(), tr.window_s
            result["breakdown"] = trace_mod.breakdown(tr)
        del tr, run
    result["metrics"] = {n: {"value": values[n], "unit": units[n]} for n in names if n in values}
    result["memory_peak_bytes"] = int(peak)

    # the check, after the window, with the program's state freed
    images = batches[w.sample_input]
    prog_labels, prog_out = w.sample_labels, w.sample_outputs
    del engine, w, batches, prof, recorder
    if cuda:
        torch.cuda.empty_cache()
    ref = Side(cfg, states, device)
    nums = numbers(cfg, images, prog_labels, prog_out, ref, seed)
    result["correct"], result["checked"] = judge(nums, spec["limits"])
    return result


def card() -> dict:
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    return {"kind": torch.cuda.get_device_name(0), "smi": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hcs_bench: the cell needs {chips} CUDA device(s), {n} visible", file=sys.stderr)
        return 2
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"hcs_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    info = card()
    print(f"hcs_bench: {info['kind']} ({info['smi']}), {args.workload}, seed {args.seed}", file=sys.stderr)
    device = {"platform": "gpu", "kind": info["kind"], "count": chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = res.pop("busy_s", 0.0)
        device["window_s"] = res.pop("trace_window_s", 0.0)
    print("hcs_bench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in res.pop("setup_parts").items()),
          file=sys.stderr)
    print("hcs_bench: seconds a batch in the window " + " ".join(f"{t:.3f}" for t in res.pop("batch_s")),
          file=sys.stderr)
    checked = res.pop("checked")
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checked"] = checked
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
