"""The system under test: ``saguaro_tpu_torch``'s segment-embed engine and
measurement, built from a configuration file, and what the windows of
``pipelines/`` share. The only module of the benchmark that imports the
program: a pipeline reaches the program's calls through this module, and a
network's config class is named by dotted path in the configuration."""

from __future__ import annotations

import dataclasses
import importlib
import time
import typing
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from saguaro_tpu_torch.pipeline.features import (
    FeatureConfig,
    measure_site_batch_dispatch,
    measure_site_batch_finalize,
)
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

PROGRAM = "saguaro_tpu_torch"


def resolve(path: str):
    """The program's object at a dotted path (``package.module.Name``)."""
    module, _, name = path.rpartition(".")
    if module.split(".")[0] != PROGRAM:
        raise ValueError(f"{path!r} is not in {PROGRAM}")
    return getattr(importlib.import_module(module), name)


def _value(hint, v):
    """A configuration file's value as a field of type ``hint`` takes it: a
    list as a tuple, each row of a tuple of dataclasses as one of them."""
    if isinstance(v, list) and typing.get_origin(hint) is tuple:
        item = typing.get_args(hint)[0]
        if dataclasses.is_dataclass(item):
            return tuple(item(*row) for row in v)
        return tuple(v)
    return v


def build_config(section: dict):
    """The program's config class named by the section's ``"class"``, built
    from the section's other keys."""
    cls = resolve(section["class"])
    hints = typing.get_type_hints(cls)
    return cls(**{k: _value(hints[k], v) for k, v in section.items() if k != "class"})


def build_engine(cfg: dict, states: dict, device) -> SegmentEmbedEngine:
    """The engine as the configuration states it, with the benchmark's
    weights: ``engine``'s keys are fields of ``SegmentEmbedConfig``; each
    section with a ``"class"`` is built into the field of its name, and
    ``states[<name>]`` goes to the engine as ``<name>_state_dict``."""
    names = {f.name for f in dataclasses.fields(SegmentEmbedConfig)}
    kw = dict(cfg["engine"])
    kw.update({k: build_config(v) for k, v in cfg.items() if isinstance(v, dict) and "class" in v})
    unknown = sorted(set(kw) - names)
    if unknown:
        raise ValueError(f"not fields of SegmentEmbedConfig: {unknown}")
    return SegmentEmbedEngine(SegmentEmbedConfig(channels=list(cfg["channels"]), **kw),
                              **{f"{k}_state_dict": v for k, v in states.items()}, seed=0, device=device)


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(channels=tuple(cfg["channels"]), **cfg["features"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What one pass over the window saw: its host-clock edges, the sites
    completed and failed, the benchmark-side spans (seconds, summed), and
    the sampled batch's inputs and outputs for the check. Spans are kept
    only while ``recording``; ``span_sites``, ``span_crops`` and
    ``span_t0`` are the sites completed, the crops embedded and the start
    of that stretch. ``t_clock`` is what the
    window's ``seconds`` count from."""

    t_start: float = 0.0
    t_end: float = 0.0
    t_clock: float = 0.0
    sites: int = 0
    failed: int = 0
    batches: int = 0
    crops: int = 0
    recording: bool = True
    span_sites: int = 0
    span_crops: int = 0
    span_t0: float = 0.0
    spans: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    batch_ends: list = field(default_factory=list)
    sample_batch: int = -1
    sample_input: int = -1
    sample_labels: np.ndarray | None = None
    sample_outputs: list | None = None

    def add_span(self, name: str, seconds: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        if self.recording:
            self.spans[name] = self.spans.get(name, 0.0) + seconds

    def start_spans(self, now: float) -> None:
        """Spans are kept from here on, and the window's seconds count from
        here."""
        self.recording, self.span_t0, self.t_clock = True, now, now


class Spans:
    """Host-clock spans around calls into the program's layers, each a
    ``bench/<name>`` range in a trace; with ``synced`` each ends in a
    device sync, so that it holds its layer's device work."""

    def __init__(self, window: Window, device, synced: bool):
        self.window, self.device, self.synced = window, device, synced

    def __call__(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        with record_function(f"bench/{name}"):
            out = fn(*args, **kw)
            if self.synced:
                sync(self.device)
        self.window.add_span(name, time.perf_counter() - t0)
        return out


class KernelRecorder:
    """While active, wraps the wrappers of the port's hand-written kernels
    (``kernels/segment_cuda``) and records each call's bytes and operations
    (``yardstick.WORK``) from its arguments' shapes. The two counts of
    pixels that K1 and K4 radial need are reduced on the device inside a
    ``bench/roofline_count`` range and read once, after the trace."""

    def __init__(self, work: dict):
        from saguaro_tpu_torch.kernels import segment_cuda

        self.sc, self.work, self.calls, self.real = segment_cuda, work, [], {}

    def __enter__(self):
        import inspect

        for name, fn in self.work.items():
            real = self.real[name] = getattr(self.sc, name)
            sig = inspect.signature(real)

            def call(*args, _name=name, _real=real, _sig=sig, _fn=fn, **kw):
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                vals = list(bound.arguments.values())
                extra = []
                if _name in ("seg_counts", "seg_radial_sums"):
                    with record_function("bench/roofline_count"):
                        lab = vals[0]
                        if _name == "seg_counts":
                            extra.append(((lab >= 0) & (lab < vals[3])).sum())
                        else:
                            extra.append(((lab > 0) & (vals[1] >= 0) & (vals[1] < vals[4])).sum())
                meta = [torch.empty_like(v, device="meta") if isinstance(v, torch.Tensor) else v
                        for v in vals]
                self.calls.append((_name, _fn, meta, extra))
                return _real(*args, **kw)

            setattr(self.sc, name, call)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.sc, name, real)

    def totals(self) -> list[tuple[str, float, float]]:
        """(kernel, bytes, operations) of each recorded call."""
        counts = [c for _, _, _, extra in self.calls for c in extra]
        host = torch.stack(counts).cpu().tolist() if counts else []
        out, i = [], 0
        for name, fn, meta, extra in self.calls:
            got = host[i : i + len(extra)]
            i += len(extra)
            out.append((name, *fn(*meta, *got)))
        return out
