"""Model checkpoints in the JAX package's format, over the storage layer
(port of ``saguaro_tpu/models/checkpoint.py``).

A file is ``b"SGTPU1\\n"``, the length of a JSON header as 8 big-endian
bytes, the header (``{"config_class": ..., "config": {...}}``, or ``{}``),
then flax's msgpack serialisation of the variables tree: nested maps under
flax's names (``params/res_down_0/proj/conv/kernel``, ``batch_stats/...``)
whose leaves are msgpack ``ExtType(1, packb((shape, dtype_name, raw
bytes)))`` in flax's layouts (HWIO convolutions, (in, out) Dense kernels).
Both packages read what either writes.

This package's networks carry torch state dicts, so a checkpoint is written
and read through the name maps of ``models/cellpose_weights.py`` and
``models/effnet_weights.py``, each leaf transposed between the torch and
flax layouts. flax and msgpack are not needed: the msgpack subset the format
uses (maps, arrays, str, bin, int, float, bool, nil, ext) is coded here.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import torch

from saguaro_tpu_torch.io import storage
from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.cellpose_weights import cellpose_name_map
from saguaro_tpu_torch.models.effnet_weights import effnet_name_map
from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config
from saguaro_tpu_torch.models.weights import flax_to_torch_layout, torch_to_flax_layout, unflatten_tree

__all__ = ["save_variables", "load_variables", "NotACheckpoint"]

MAGIC = b"SGTPU1\n"
# flax's msgpack extension codes (flax.serialization._MsgpackExtType)
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class NotACheckpoint(ValueError):
    """The file does not start with the format's magic bytes."""


# ----------------------------------------------------------------------------
# msgpack, the subset flax's serialisation uses


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif isinstance(obj, bool):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out += struct.pack(">B", obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            out += struct.pack(">BQ", 0xCF, obj)
        else:
            out += struct.pack(">Bq", 0xD3, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        out += struct.pack(">B", 0xA0 | n) if n < 32 else struct.pack(">BI", 0xDB, n)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        out += struct.pack(">BI", 0xC6, len(obj))
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out += struct.pack(">B", 0x90 | n) if n < 16 else struct.pack(">BI", 0xDD, n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out += struct.pack(">B", 0x80 | n) if n < 16 else struct.pack(">BI", 0xDF, n)
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, torch.Tensor):
        data = _tensor_bytes(obj)
        out += struct.pack(">BIb", 0xC9, len(data), EXT_NDARRAY)
        out += data
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} into a checkpoint")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list, tuple, str, bytes, int, float,
    bool, None; a tensor as flax's ndarray extension)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """flax's ndarray payload: packb((shape, dtype name, C-order bytes))."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype not in _DTYPE_NAMES:
        raise TypeError(f"cannot write a {t.dtype} tensor into a checkpoint")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return packb((list(t.shape), _DTYPE_NAMES[t.dtype], raw))


def _tensor_from_bytes(data: bytes) -> torch.Tensor:
    shape, name, raw = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"checkpoint array of dtype {name!r}, which this reader does not know")
    dtype = _DTYPES[name]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


# first byte -> (struct format of the length or value, kind)
_FIXED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"), 0xCF: (">Q", "value"),
    0xD0: (">b", "value"), 0xD1: (">h", "value"), 0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b < 0xA0:
        kind, n = "array", b & 0x0F
    elif 0xA0 <= b < 0xC0:
        kind, n = "str", b & 0x1F
    elif b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    elif b in _FIXEXT:
        kind, n = "ext", _FIXEXT[b]
    elif b in _FIXED:
        fmt, kind = _FIXED[b]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if kind == "value":
            return n, pos
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} at {pos - 1} is not part of the format")
    if kind == "str":
        return bytes(buf[pos : pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos : pos + n]), pos + n
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        data = bytes(buf[pos + 1 : pos + 1 + n])
        if code == EXT_NDARRAY:
            return _tensor_from_bytes(data), pos + 1 + n
        if code == EXT_NPSCALAR:
            return _tensor_from_bytes(data).reshape(()), pos + 1 + n
        raise ValueError(f"msgpack extension type {code} is not part of the format")
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data: bytes):
    """The object msgpack ``data`` holds (flax's ndarray and numpy-scalar
    extensions as tensors on the CPU)."""
    try:
        obj, pos = _unpack(memoryview(data), 0)
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"truncated or corrupt msgpack: {e}") from e
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the msgpack object")
    return obj


# ----------------------------------------------------------------------------
# checkpoints


def _name_map(config) -> dict[str, str]:
    if isinstance(config, CellposeConfig):
        return cellpose_name_map(config)
    if isinstance(config, EffNetV2Config):
        if config.fold_bn:
            raise ValueError("a folded EffNetV2 (fold_bn=True) has no BatchNorms to write or read; "
                             "use the unfolded network, folded after loading")
        return effnet_name_map(config)
    raise TypeError(f"no checkpoint name map for a {type(config).__name__}")


def save_variables(path: str, variables, config=None) -> None:
    """Write a network's weights in the JAX package's checkpoint format.

    ``variables``: a ``CellposeUNet`` or an unfolded ``EffNetV2``, or its
    state dict; ``config``: the network's dataclass config, written into the
    header (and needed with a state dict, to name its leaves)."""
    if isinstance(variables, torch.nn.Module):
        arch = config or variables.config
        variables = variables.state_dict()
    elif config is None:
        raise ValueError("a state dict is written with its network's config")
    else:
        arch = config
    header: dict = {}
    if config is not None:
        header["config_class"] = type(config).__name__
        header["config"] = dataclasses.asdict(config)
    flat = {fkey: torch_to_flax_layout(variables[tkey].detach().to("cpu")) for fkey, tkey in _name_map(arch).items()}
    header_bytes = json.dumps(header, default=str).encode("utf-8")
    payload = packb(unflatten_tree(flat))
    storage.write_bytes(path, MAGIC + len(header_bytes).to_bytes(8, "big") + header_bytes + payload)


def load_variables(path: str, template: torch.nn.Module) -> tuple[dict, dict]:
    """Read a checkpoint (either package's) for ``template``'s network (a
    ``CellposeUNet`` or an unfolded ``EffNetV2``): returns (its state dict,
    on the CPU in the template's dtypes; the header dict).

    Raises ``NotACheckpoint`` (a ``ValueError``) when the file does not start
    with the magic bytes, and ``ValueError`` when a weight of the template's
    network is missing or has another shape. Leaves the map does not name
    are ignored, as flax ignores them."""
    blob = storage.read_bytes(path)
    if not blob.startswith(MAGIC):
        raise NotACheckpoint(f"{path} is not a saguaro_tpu checkpoint")
    off = len(MAGIC)
    hlen = int.from_bytes(blob[off : off + 8], "big")
    off += 8
    header = json.loads(blob[off : off + hlen].decode("utf-8"))
    tree = unpackb(blob[off + hlen :])
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the payload is a {type(tree).__name__}, not a variables tree")
    flat = _flatten(tree)
    name_map = _name_map(template.config)
    if isinstance(template.config, EffNetV2Config) and "batch_stats" not in tree:
        folded = sorted(k for k in flat if k not in name_map)
        raise ValueError(f"{path} holds folded EfficientNet variables (no batch_stats), which do not "
                         f"map onto the unfolded network: {folded}")
    want = template.state_dict()
    missing = [f for f in name_map if not isinstance(flat.get(f), torch.Tensor)]
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} weights of the network: {missing}")
    sd = {tkey: flax_to_torch_layout(flat[fkey]) for fkey, tkey in name_map.items()}
    bad = [f"{fkey} {tuple(flat[fkey].shape)}, the network's {tuple(want[tkey].shape)} as "
           f"{tuple(torch_to_flax_layout(want[tkey]).shape)}"
           for fkey, tkey in name_map.items() if sd[tkey].shape != want[tkey].shape]
    if bad:
        raise ValueError(f"{path}: weights of the wrong shape: {bad}")
    return {k: v.to(want[k].dtype) for k, v in sd.items()}, header


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
