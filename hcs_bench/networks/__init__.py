"""The networks a configuration runs, one module a network,
``networks/<name>.py``, found by the name the configuration gives it under
a role: ``"segmenter": "cpnet"``, ``"embedder": "effnetv2"``. A new network
is a new module here and imports nothing of the program. Each supplies:

- ``SECTION``: the configuration's key that holds the network's sizes. The
  section's ``"class"`` is the dotted path of the program's config class,
  built from the section's other keys into the engine's config field of
  that name; the program's engine takes the weights as
  ``<SECTION>_state_dict`` (``program.build_engine``).
- ``weights(cfg, traffic, batches, nuclei, seed, device)``: its state dict,
  made on ``device`` from the seed with the reference's own definitions.
- ``flops(cfg, traffic)``: its FLOPs for one unit of its role's work
  (``ROLES``: a site for a segmenter, a crop for an embedder).
- ``forward(cfg, state, device, lower=False)``: a callable, its plain
  float32 forward pass for the reference, or with ``lower`` the control's
  lower precision. A segmenter's maps (N, C, tile, tile) network input to
  (N, 3, tile, tile) [flow_y, flow_x, cellprob logit]
  (``reference/cellpose_ref.segment``); an embedder's maps (n, box, box)
  masked crops to (n, D) embeddings (``reference/embed.embed``)."""

from __future__ import annotations

import importlib

# each role a configuration may name, with the unit its FLOPs are counted in
ROLES = {"segmenter": "site", "embedder": "crop"}


def load(name: str):
    """The module of the network named ``name``."""
    return importlib.import_module(f"{__name__}.{name}")


def named(cfg: dict) -> list:
    """(role, module) of each network the configuration names, in
    ``ROLES``' order."""
    return [(role, load(cfg[role])) for role in ROLES if role in cfg]
