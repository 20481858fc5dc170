"""The port's copy of the suite configuration (``saguaro_tpu_torch.config``)
reads the same YAML and JSON files into the same stage configs as the
reference's, on the port's own dataclasses."""

import json

import pytest

from saguaro_tpu import config as ref
from saguaro_tpu_torch import config as port
from saguaro_tpu_torch.pipeline.features import FeatureConfig
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig

from .torch_data import share_cpu_threads

share_cpu_threads()

DOC = {
    "channels": ["DNA", "ER", "RNA"],
    "max_cells": 256,
    "segment_embed": {"diameter": 80, "single_cell": True, "unknown_key": 1,
                      "cellpose": {"features": [8, 16, 32, 64]}},
    "features": {"glcm_levels": 8, "texture_scale": 5},
}


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_stage_configs_match_reference(tmp_path, suffix):
    path = tmp_path / f"suite{suffix}"
    if suffix == ".yaml":
        import yaml

        path.write_text(yaml.safe_dump(DOC))
    else:
        path.write_text(json.dumps(DOC))
    assert port.load_config(str(path)) == ref.load_config(str(path)) == DOC
    seg = port.load_stage_config(str(path), "segment_embed", SegmentEmbedConfig)
    assert (seg.channels, seg.max_cells, seg.diameter, seg.single_cell) == (
        ["DNA", "ER", "RNA"], 256, 80, True)
    assert tuple(seg.cellpose.features) == (8, 16, 32, 64)
    feat = port.load_stage_config(str(path), "features", FeatureConfig, channels=("DNA",))
    assert (feat.channels, feat.max_cells, feat.glcm_levels, feat.texture_scale) == (
        ("DNA",), 256, 8, 5)
