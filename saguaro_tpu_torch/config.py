"""Suite configuration: one YAML/JSON file -> typed stage configs (a copy
of ``saguaro_tpu/config.py``, which imports no JAX, on the port's storage
layer).

The reference has no config system — argparse per script plus hardcoded
module constants (SURVEY.md §5). Here a single config file can drive every
stage; CLI flags still win (flags are parsed per stage and merged over the
file).

Example:

```yaml
channels: [DNA, ER, RNA, AGP, Mito]
segment_embed:
  diameter: 100
  max_cells: 512
  single_cell: true
features:
  glcm_levels: 16
  texture_scale: 3
```
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, TypeVar

from saguaro_tpu_torch.io import storage

__all__ = ["load_config", "build_dataclass", "load_stage_config"]

T = TypeVar("T")


def load_config(path: str) -> dict:
    raw = storage.read_bytes(path).decode("utf-8")
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(raw) or {}
    return json.loads(raw)


def build_dataclass(cls: type[T], data: dict[str, Any], **overrides) -> T:
    """Instantiate a (possibly nested) dataclass from a plain dict,
    ignoring unknown keys; ``overrides`` win over the file values."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for name, value in {**data, **overrides}.items():
        if name not in fields:
            continue
        ftype = fields[name].type
        field_default = fields[name].default_factory if fields[name].default_factory is not dataclasses.MISSING else None
        if isinstance(value, dict):
            # nested dataclass: resolve the type from the default instance
            default = (
                field_default()
                if field_default is not None
                else fields[name].default
            )
            if dataclasses.is_dataclass(default):
                value = build_dataclass(type(default), value)
        kwargs[name] = value
    return cls(**kwargs)


def load_stage_config(path: str, stage: str, cls: type[T], **overrides) -> T:
    """Load ``stage``'s section (merged over top-level keys) into ``cls``."""
    doc = load_config(path)
    merged = {k: v for k, v in doc.items() if not isinstance(v, dict)}
    merged.update(doc.get(stage, {}) or {})
    return build_dataclass(cls, merged, **overrides)
