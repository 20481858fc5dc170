"""Weight layouts between flax variable trees and torch state dicts (port of
``saguaro_tpu/models/weights.py``), and the torch checkpoint files both
networks take.

The reference module converts torch-style state dicts to flax trees:

* layout converters (OIHW -> HWIO convolutions, depthwise convolutions,
  Linear transposes); here also both directions on torch tensors
  (``torch_to_flax_layout``, ``flax_to_torch_layout``), which the
  checkpoint format and the flax bridge use;
* ``convert_state_dict``: a state dict onto a flax variables tree through an
  explicit name map, with strict shape checks;
* ``convert_by_order``: the structural fallback that pairs tensors by
  traversal order and shape signature, reporting every decision.

Those work on numpy arrays, as in the reference. This package's networks
carry the torch key layouts themselves (cellpose's CPnet keys, timm's
EfficientNetV2 keys), so the flax trees are needed only at the edges: the
JAX package's variables bridged onto a state dict (``state_dict_from_flax``)
and its checkpoint format (``models/checkpoint.py``). The name maps, the
torch-file loaders and the flax -> torch bridges of each network live in
``models/cellpose_weights.py`` and ``models/effnet_weights.py``; their
names stay importable from here.
"""

from __future__ import annotations

import importlib
import io
import pickle
from typing import Callable

import numpy as np
import torch

from saguaro_tpu_torch.io import storage

__all__ = [
    "conv_torch_to_flax",
    "depthwise_torch_to_flax",
    "linear_torch_to_flax",
    "flatten_tree",
    "unflatten_tree",
    "convert_state_dict",
    "convert_by_order",
    "torch_to_flax_layout",
    "flax_to_torch_layout",
    "state_dict_from_flax",
    "read_torch_state_dict",
    "strip_prefixes",
    "cellpose_name_map",
    "cellpose_state_dict_from_flax",
    "load_cellpose_checkpoint",
    "effnet_name_map",
    "effnet_state_dict_from_flax",
    "load_effnet_checkpoint",
]

# wrappers' key prefixes (transformers' TimmWrapperModel, DataParallel, ...)
PREFIXES = ("timm_model.", "module.", "model.")

# names defined by the per-network modules, importable from here:
# {name here: (module, name there)}
_MOVED = {
    "cellpose_name_map": ("cellpose_weights", "cellpose_name_map"),
    "cellpose_state_dict_from_flax": ("cellpose_weights", "cellpose_state_dict_from_flax"),
    "load_cellpose_checkpoint": ("cellpose_weights", "load_torch_cellpose"),
    "effnet_name_map": ("effnet_weights", "effnet_name_map"),
    "effnet_state_dict_from_flax": ("effnet_weights", "effnet_state_dict_from_flax"),
    "load_effnet_checkpoint": ("effnet_weights", "load_torch_effnet"),
}


def __getattr__(name: str):
    """The per-network names, imported on first use (those modules import
    this one)."""
    if name not in _MOVED:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _MOVED[name]
    return getattr(importlib.import_module(f"saguaro_tpu_torch.models.{module}"), attr)


def conv_torch_to_flax(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def depthwise_torch_to_flax(w: np.ndarray) -> np.ndarray:
    """torch depthwise (C, 1, kh, kw) -> flax feature-grouped (kh, kw, 1, C)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def linear_torch_to_flax(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(np.asarray(w))


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flax variables tree -> {'a/b/c': array}."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def convert_state_dict(
    state_dict: dict[str, np.ndarray],
    flax_variables: dict,
    name_map: dict[str, str],
    transforms: dict[str, Callable[[np.ndarray], np.ndarray]] | None = None,
) -> dict:
    """Explicit-table conversion.

    name_map: {flax_flat_key: torch_key}; transforms: optional per-flax-key
    layout converter (default: inferred from rank — 4D conv transpose, 2D
    linear transpose, 1D copy). Shape mismatches raise.
    """
    transforms = transforms or {}
    flat = flatten_tree(flax_variables)
    new_flat: dict[str, np.ndarray] = {}
    for fkey, cur in flat.items():
        if fkey not in name_map:
            new_flat[fkey] = cur
            continue
        t = np.asarray(state_dict[name_map[fkey]])
        if fkey in transforms:
            t = transforms[fkey](t)
        elif t.ndim == 4:
            t = (
                depthwise_torch_to_flax(t)
                if t.shape[1] == 1 and cur.shape[2] == 1
                else conv_torch_to_flax(t)
            )
        elif t.ndim == 2 and t.shape != cur.shape:
            t = linear_torch_to_flax(t)
        if t.shape != cur.shape:
            raise ValueError(
                f"{fkey}: converted shape {t.shape} != expected {cur.shape} "
                f"(torch key {name_map[fkey]})"
            )
        new_flat[fkey] = t.astype(cur.dtype)
    return unflatten_tree(new_flat)


def _signature(shape: tuple[int, ...]) -> tuple:
    """Order-insensitive conv/linear signature for structural pairing."""
    return (len(shape), tuple(sorted(shape)))


def _interleaved_flax_keys(flat: dict[str, np.ndarray]) -> list[str]:
    """Order flax leaves the way a torch state dict orders tensors.

    flatten_tree yields all of ``params/`` before ``batch_stats/``, but
    torch emits each BatchNorm's running stats right after its
    weight/bias. Re-interleave: walk params in module order and splice
    each module's batch_stats (mean then var) in as the module ends.
    """
    params = [k for k in flat if k.startswith("params/")]
    stats_by_mod: dict[str, list[str]] = {}
    for k in flat:
        if k.startswith("params/"):
            continue
        mod = k.split("/", 1)[1].rsplit("/", 1)[0]
        stats_by_mod.setdefault(mod, []).append(k)
    leaf_rank = {"mean": 0, "var": 1}
    for v in stats_by_mod.values():
        v.sort(key=lambda k: leaf_rank.get(k.rsplit("/", 1)[1], 99))

    out: list[str] = []
    prev_mod: str | None = None
    for k in params:
        mod = k.split("/", 1)[1].rsplit("/", 1)[0]
        if prev_mod is not None and mod != prev_mod and prev_mod in stats_by_mod:
            out.extend(stats_by_mod.pop(prev_mod))
        out.append(k)
        prev_mod = mod
    if prev_mod is not None and prev_mod in stats_by_mod:
        out.extend(stats_by_mod.pop(prev_mod))
    for rem in stats_by_mod.values():
        out.extend(rem)
    return out


def convert_by_order(
    state_dict: dict[str, np.ndarray],
    flax_variables: dict,
    skip_torch: Callable[[str], bool] | None = None,
) -> tuple[dict, list[str]]:
    """Structural conversion: pair torch tensors with flax leaves in
    traversal order when their shape signatures match.

    Returns (converted variables, report lines). Tensors that cannot be
    paired are reported and left at their initialized values — the report
    is the parity-debugging artifact.
    """
    flat = flatten_tree(flax_variables)
    torch_items = [
        (k, np.asarray(v))
        for k, v in state_dict.items()
        if not (skip_torch and skip_torch(k)) and hasattr(v, "shape")
    ]
    report: list[str] = []
    used = [False] * len(torch_items)
    new_flat: dict[str, np.ndarray] = {}
    for fkey in _interleaved_flax_keys(flat):
        cur = flat[fkey]
        sig = _signature(cur.shape)
        found = None
        for j in range(len(torch_items)):
            tk, tv = torch_items[j]
            if used[j]:
                continue
            conv = tv
            if tv.ndim == 4:
                conv = (
                    depthwise_torch_to_flax(tv)
                    if tv.shape[1] == 1 and cur.ndim == 4 and cur.shape[2] == 1
                    else conv_torch_to_flax(tv)
                )
            elif tv.ndim == 2 and tv.shape != cur.shape:
                conv = linear_torch_to_flax(tv)
            if conv.shape == cur.shape and _signature(tv.shape) == sig:
                found = (j, tk, conv)
                break
        if found is None:
            report.append(f"UNMATCHED flax {fkey} {cur.shape}")
            new_flat[fkey] = cur
        else:
            j, tk, conv = found
            used[j] = True
            report.append(f"{fkey} <- {tk} {tuple(conv.shape)}")
            new_flat[fkey] = conv.astype(cur.dtype)
    for j, (tk, tv) in enumerate(torch_items):
        if not used[j]:
            report.append(f"UNUSED torch {tk} {tuple(tv.shape)}")
    return unflatten_tree(new_flat), report


def torch_to_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """A torch leaf in its flax layout, by rank: convolution weights (O, I,
    kh, kw) -> (kh, kw, I, O) (depthwise (C, 1, kh, kw) -> (kh, kw, 1, C)
    by the same transpose), Linear weights (out, in) -> (in, out), vectors
    as they are. Every 2-D leaf of both networks is a Linear weight, square
    ones included (res_up_3's style layers), so the rank alone decides."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0).contiguous()
    if t.dim() == 2:
        return t.t().contiguous()
    return t


def flax_to_torch_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``torch_to_flax_layout``."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 2:
        return t.t().contiguous()
    return t


def state_dict_from_flax(variables_as_numpy: dict, name_map: dict[str, str]) -> dict[str, torch.Tensor]:
    """A flax ``{'params': ..., 'batch_stats': ...}`` tree of numpy arrays ->
    a state dict under ``name_map`` ({flax flat key: torch key}), every leaf
    in its torch layout, f32. Every mapped key must be present."""
    flat = flatten_tree(variables_as_numpy)
    return {tkey: flax_to_torch_layout(torch.tensor(np.asarray(flat[fkey], np.float32)))
            for fkey, tkey in name_map.items()}


def read_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A torch checkpoint file (local or through ``io.storage``) -> its
    tensors on the CPU: ``state_dict`` and ``model`` wrappers unwrapped, the
    wrappers' key prefixes stripped. Only tensors and plain containers are
    unpickled (``weights_only=True``); a file that is no torch save raises
    ``ValueError``."""
    blob = storage.read_bytes(path)
    try:
        obj = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(f"{path} is not a torch file (a saguaro_tpu checkpoint reads with "
                         f"models.checkpoint.load_variables): {e}") from e
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a state dict")
    return strip_prefixes({k: v for k, v in obj.items() if isinstance(v, torch.Tensor)})


def strip_prefixes(state_dict: dict) -> dict:
    """Drop the wrappers' key prefixes (``PREFIXES``), each where any key
    carries it."""
    for prefix in PREFIXES:
        if any(k.startswith(prefix) for k in state_dict):
            state_dict = {(k[len(prefix):] if k.startswith(prefix) else k): v
                          for k, v in state_dict.items()}
    return state_dict
