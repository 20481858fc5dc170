"""Device mesh and site-batch sharding (port of
``saguaro_tpu/parallel/mesh.py``).

The reference's only parallelism is process pools and an EC2 fleet; the
JAX package replaces them with one controller over a ``jax.sharding.Mesh``.
The port keeps that shape: one process, one host thread, a (data, model)
grid of devices and per-device replicas of what every shard reads:

* a site batch is split along its leading axis into one contiguous shard a
  data row (``shard_batch``), each shard runs on its device, and the
  results are gathered back in site order (no collective: the work is
  embarrassingly parallel);
* model weights are replicated, one copy a data device (``replicate``), or
  split over the model axis on their largest divisible dimension
  (``fsdp_param_sharding``).

``torch.distributed``'s ``DeviceMesh`` is not used: it wants one process a
device. A mesh's device list may repeat a device (``make_mesh(devices=
[cuda:0, cuda:0])`` is a 2-way mesh on one card, ``["cpu"] * 8`` the
reference's eight CPU devices): the shards then run one after another on
it, which tests the sharded code paths where only one device exists.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Mesh",
    "ShardedBatch",
    "ParamShards",
    "make_mesh",
    "default_mesh",
    "default_mesh_for",
    "visible_devices",
    "batch_sharding",
    "shard_batch",
    "replicate",
    "fsdp_param_sharding",
]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices, ``devices`` in row-major order: data
    row i holds ``devices[i * model : (i + 1) * model]``."""

    devices: tuple[torch.device, ...]
    data: int
    model: int = 1
    axis_names: tuple[str, str] = ("data", "model")

    def __post_init__(self):
        if self.data * self.model != len(self.devices) or self.data < 1 or self.model < 1:
            raise ValueError(f"mesh {self.data}x{self.model} != {len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The first device of each data row: where a batch shard runs."""
        return self.devices[:: self.model]


def visible_devices() -> list[torch.device]:
    """Every CUDA device this process sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    model: int = 1,
    devices: list | None = None,
) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA device). ``devices`` may name a device
    more than once: ``[cuda:0, cuda:0]`` is a 2-way mesh on one card, and
    ``["cpu"] * 8`` the eight CPU entries the CPU tests shard over."""
    devs = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    n = n_devices or len(devs)
    if n < 1 or n > len(devs):
        raise ValueError(f"a mesh of {n} devices over {len(devs)} available")
    devs = devs[:n]
    data = data or n // model
    return Mesh(tuple(devs), data, model)


def default_mesh(n_devices: int | None = None) -> Mesh | None:
    """The production default: a data-parallel mesh over every visible
    device, or None on one device (or none). ``n_devices`` (a CLI's
    ``--devices``) overrides the count; 1 forces one device."""
    n = n_devices if n_devices is not None else len(visible_devices())
    if n <= 1:
        return None
    return make_mesh(n, devices=visible_devices())


def default_mesh_for(device=None, n_devices: int | None = None) -> Mesh | None:
    """The automatic mesh of an entry point that also takes a ``device``:
    ``default_mesh(n_devices)`` when ``device`` is unset or names CUDA
    without an index, else None: a named CPU or a pinned card (``cuda:1``)
    runs there alone. Asking for several devices (``n_devices`` > 1) with
    such a device raises."""
    if device is not None:
        d = torch.device(device)
        if d.type != "cuda" or d.index is not None:
            if n_devices is not None and n_devices > 1:
                raise ValueError(f"a mesh of {n_devices} devices asked for with device {d}: name "
                                 "no device, or 'cuda', to shard over the visible cards")
            return None
    return default_mesh(n_devices)


@dataclass(frozen=True)
class BatchSharding:
    """The leading axis split over ``data`` in contiguous chunks, the other
    ``ndim - 1`` axes whole (the reference's ``P("data", None, ...)``)."""

    mesh: Mesh
    ndim: int

    def bounds(self, batch: int) -> list[tuple[int, int]]:
        """[start, stop) of each data row's shard of a ``batch``-long axis."""
        d = self.mesh.data
        if batch % d:
            raise ValueError(f"a batch of {batch} does not split evenly over {d} data devices")
        k = batch // d
        return [(i * k, (i + 1) * k) for i in range(d)]


def batch_sharding(mesh: Mesh, ndim: int) -> BatchSharding:
    """Shard the leading (batch) axis over 'data', keep the rest whole."""
    return BatchSharding(mesh, ndim)


@dataclass
class ShardedBatch:
    """A batch split along its leading axis: ``shards[i]`` lies on
    ``devices[i]``, in site order."""

    shards: list[torch.Tensor]
    devices: tuple[torch.device, ...]

    def __len__(self) -> int:
        return sum(s.shape[0] for s in self.shards)

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self),) + tuple(self.shards[0].shape[1:])

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole batch on ``device`` (default: the first shard's), in
        site order."""
        dev = torch.device(device) if device is not None else self.devices[0]
        return torch.cat([s.to(dev) for s in self.shards])


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)  # torch has no uint16 arithmetic
    return torch.as_tensor(arr)


def shard_batch(x, mesh: Mesh) -> ShardedBatch:
    """Split ``x`` (a tensor or array, B leading) into one contiguous chunk
    a data row, each on its row's device. Raises ValueError when B is not a
    multiple of the data axis, as a ``NamedSharding`` does."""
    x = _as_tensor(x)
    sharding = batch_sharding(mesh, x.dim())
    devs = mesh.data_devices
    shards = [x[a:b].to(d) for (a, b), d in zip(sharding.bounds(x.shape[0]), devs)]
    return ShardedBatch(shards, devs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree_or_module, mesh: Mesh) -> list:
    """One copy of a module (or of a tree of tensors and arrays) a data
    device, in data-row order. A module already on the first data device is
    its own first replica; every other replica is a copy."""
    devs = mesh.data_devices
    if isinstance(tree_or_module, torch.nn.Module):
        module = tree_or_module
        first = next(iter(module.parameters()), None)
        out = []
        for i, d in enumerate(devs):
            if i == 0 and first is not None and first.device == d:
                out.append(module)
            else:
                out.append(copy.deepcopy(module).to(d))
        return out
    return [_tree_map(lambda t, d=d: _as_tensor(t).detach().to(d, copy=True), tree_or_module)
            for d in devs]


@dataclass
class ParamShards:
    """A parameter split over the model axis along ``dim`` (None:
    replicated), ``shards[j]`` on model column j's device of the first data
    row."""

    dim: int | None
    shards: list[torch.Tensor]

    @property
    def is_fully_replicated(self) -> bool:
        return self.dim is None

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else self.shards[0].device
        if self.dim is None:
            return self.shards[0].to(dev)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.dim)


def fsdp_param_sharding(tree, mesh: Mesh, min_size: int = 2**16):
    """FSDP-style placement of a parameter tree: a leaf of at least
    ``min_size`` elements splits over the 'model' axis on its largest
    dimension that divides evenly; smaller leaves (and all of them when the
    model axis is 1) are replicated. Returns the tree of ``ParamShards``."""
    m = mesh.model
    row = mesh.devices[:m]

    def place(x):
        t = _as_tensor(x).detach()
        if m == 1 or t.dim() == 0 or t.numel() < min_size:
            return ParamShards(None, [t.to(d, copy=True) for d in row])
        for i in sorted(range(t.dim()), key=lambda i: -t.shape[i]):
            if t.shape[i] % m == 0:
                return ParamShards(i, [c.to(d, copy=True) for c, d in zip(t.chunk(m, dim=i), row)])
        return ParamShards(None, [t.to(d, copy=True) for d in row])

    return _tree_map(place, tree)
