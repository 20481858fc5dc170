"""Run manifest: per-unit completion tracking for resumable runs (a copy of
``saguaro_tpu/pipeline/manifest.py``, which imports no JAX).

The reference has no checkpoint/resume — its only recovery mechanisms are
per-site npz spill files and re-runnable idempotent stages (SURVEY.md §5).
This manifest makes every run resumable: each completed unit (site,
well, plate x time job) is recorded as one JSON line; on restart the
run skips completed units and re-dispatches the rest deterministically.
"""

from __future__ import annotations

import json
import time

from saguaro_tpu_torch.io import storage

__all__ = ["Manifest"]


class Manifest:
    """Append-only JSONL completion log over the storage layer."""

    def __init__(self, path: str):
        self.path = path
        self._done: dict[str, dict] = {}
        if storage.exists(path):
            text = storage.read_bytes(path).decode("utf-8")
            for line in text.splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                self._done[rec["unit"]] = rec

    def is_done(self, unit: str) -> bool:
        return unit in self._done

    def pending(self, units: list[str]) -> list[str]:
        return [u for u in units if u not in self._done]

    def mark_done(self, unit: str, **info) -> None:
        rec = {"unit": unit, "ts": time.time(), **info}
        self._done[unit] = rec
        line = (json.dumps(rec) + "\n").encode("utf-8")
        try:
            # true append where the filesystem supports it (local, most
            # fsspec backends) — O(1) per unit instead of O(n) rewrites
            with storage.open_file(self.path, "ab") as f:
                f.write(line)
        except Exception:
            # object stores without append: full rewrite from memory
            blob = "".join(
                json.dumps(r) + "\n" for r in self._done.values()
            ).encode("utf-8")
            storage.write_bytes(self.path, blob)

    def info(self, unit: str) -> dict | None:
        return self._done.get(unit)

    def __len__(self) -> int:
        return len(self._done)
