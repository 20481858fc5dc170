"""Crop extraction (``kernels/crops.py``) against the reference: centroids,
counts, the edge rule and the masked crops are exact, for cells on the
edge and one pixel inside it, ids >= max_cells, an empty site and odd
sizes; ``gather_crops`` cuts the same crops for any slot list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels.crops import extract_crops as ref_extract
from saguaro_tpu.kernels.crops import label_centroids as ref_centroids
from saguaro_tpu_torch.kernels.crops import extract_crops, gather_crops, label_centroids

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

BOX = 16


def edge_site(h: int, w: int, seed: int = 0):
    """(image (h, w, 2) f32, labels (h, w) int32): square cells whose
    centroids lie exactly on each edge of the rule (box // 2 from the
    border, and at h - box // 2) and one pixel inside or outside it, a cell
    with an id >= max_cells, and a cell of one pixel."""
    rng = np.random.default_rng(seed)
    half = BOX // 2
    lab = np.zeros((h, w), np.int32)
    centres = [(half, half), (half - 1, 20), (20, half + 1), (h - half, 20), (h - half + 1, 30),
               (30, w - half), (24, w - half - 1), (h // 2, w // 2)]
    for k, (cy, cx) in enumerate(centres, start=1):
        lab[cy - 1 : cy + 2, cx - 1 : cx + 2] = k
    lab[3, w - 3] = 9                          # one pixel
    lab[h - 4 : h - 2, 2:4] = 70                # beyond max_cells
    image = rng.integers(0, 4000, (h, w, 2)).astype(np.float32)
    return image, lab


CASES = {
    "edges_even": edge_site(48, 64),
    "edges_odd": edge_site(47, 61, seed=1),
    "blobs_odd": tuple(a[0] for a in blob_sites(1, 45, 53, n_ch=3, n_cells=9, seed=2)),
    "empty": (np.ones((40, 40, 2), np.float32), np.zeros((40, 40), np.int32)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("max_cells", [8, 64])
def test_label_centroids_match_reference(case, max_cells):
    _, lab = CASES[case]
    want = [np.asarray(a) for a in ref_centroids(jnp.asarray(lab), max_cells)]
    got = [a.numpy() for a in label_centroids(torch.from_numpy(lab), max_cells)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("max_cells", [8, 64])
def test_extract_crops_match_reference(case, max_cells):
    image, lab = CASES[case]
    want = [np.asarray(a) for a in ref_extract(jnp.asarray(image), jnp.asarray(lab), max_cells, BOX)]
    got = [a.numpy() for a in extract_crops(torch.from_numpy(image), torch.from_numpy(lab), max_cells, BOX)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_edge_rule_keeps_the_boundary_cells():
    """Centroids exactly box // 2 from a border pass (cells 1, 4, 6: ``<=``
    on the upper side), one pixel inside pass (3, 7), one pixel outside fail
    (2, 5), and ids >= max_cells are never valid."""
    image, lab = CASES["edges_even"]
    _, valid, _ = extract_crops(torch.from_numpy(image), torch.from_numpy(lab), 64, BOX)
    assert valid.nonzero().flatten().tolist() == [1, 3, 4, 6, 7, 8]


def test_batched_centroids_equal_per_site():
    _, lab = blob_sites(3, 40, 44, n_ch=1, n_cells=6, seed=4)
    got = label_centroids(torch.from_numpy(lab), 16)
    for s in range(3):
        one = label_centroids(torch.from_numpy(lab[s]), 16)
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


def test_gather_crops_cuts_any_slot_list():
    images, lab = blob_sites(2, 50, 56, n_ch=3, n_cells=8, seed=5)
    chw = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    rng = np.random.default_rng(0)
    site, label, ch = rng.integers(0, 2, 11), rng.integers(1, 9, 11), rng.integers(0, 3, 11)
    cy, cx = rng.integers(0, 50, 11), rng.integers(0, 56, 11)
    got = gather_crops(chw, torch.from_numpy(lab), *(torch.from_numpy(a) for a in (site, label, ch, cy, cx)),
                       box=BOX)
    assert got.shape == (11, BOX, BOX)
    for j in range(11):
        y0, x0 = np.clip(cy[j] - BOX // 2, 0, 50 - BOX), np.clip(cx[j] - BOX // 2, 0, 56 - BOX)
        win = (slice(y0, y0 + BOX), slice(x0, x0 + BOX))
        want = images[site[j]][win][..., ch[j]] * (lab[site[j]][win] == label[j])
        np.testing.assert_array_equal(got[j].numpy(), want)
