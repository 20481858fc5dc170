"""Secondary/tertiary objects and granularity: the port against the
reference. Label races and dilations are exact (the same f32 step costs
and strict comparisons). Granularity spectra agree to 1e-4 of the
spectrum's largest value: each entry is a mean over the plane, summed in
another order than XLA's.

The card's granularity kernel (K8, ``csrc/granularity.cu``) runs only on
the card; here a NumPy model of its schedule (tiles with a 1-pixel halo,
in-place line scans to local stability, grid rounds until no tile is
marked) is held bit for bit against the plain reconstruction, and its
spectrum against the plain one within rtol 1e-5 (the per-plane sums are
taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import morphology as ref
from saguaro_tpu.kernels.thresholding import global_threshold as ref_threshold
from saguaro_tpu_torch.kernels import morphology as port

from saguaro_tpu_torch.kernels import segment_cuda

from .torch_data import blob_sites, share_cpu_threads, spiral_path

share_cpu_threads()


@pytest.fixture(scope="module")
def sites():
    img, lab = blob_sites(n_sites=2, h=56, w=60, n_ch=3, n_cells=8, seed=13, overflow_id=None)
    body = img[..., 1:].mean(axis=-1)
    thr = np.array([float(ref_threshold(body[s])[0]) for s in range(len(body))], np.float32)
    return img, lab, body, thr


@pytest.mark.parametrize("iterations", [None, 3])
def test_propagate_labels_exact(sites, iterations):
    _, lab, body, thr = sites
    mask = body >= thr[:, None, None]
    got = port.propagate_labels(
        torch.from_numpy(lab), torch.from_numpy(body), torch.from_numpy(thr),
        iterations=iterations, regularization=0.05, mask=torch.from_numpy(mask),
    ).numpy()
    for s in range(len(lab)):
        want = np.asarray(ref.propagate_labels(
            lab[s], body[s], thr[s], iterations=iterations, regularization=0.05, mask=mask[s]
        ))
        np.testing.assert_array_equal(got[s], want)
    assert (got > 0).sum() > (lab > 0).sum()  # cells grew past the nuclei


def test_propagate_labels_threshold_without_mask(sites):
    _, lab, body, thr = sites
    got = port.propagate_labels(torch.from_numpy(lab), torch.from_numpy(body), float(thr[0])).numpy()
    for s in range(len(lab)):
        want = np.asarray(ref.propagate_labels(lab[s], body[s], float(thr[0])))
        np.testing.assert_array_equal(got[s], want)


def test_expand_and_tertiary_exact(sites):
    _, lab, body, thr = sites
    got = port.expand_labels(torch.from_numpy(lab), torch.from_numpy(body), torch.from_numpy(thr), 4)
    cyto = port.tertiary_objects(got, torch.from_numpy(lab)).numpy()
    for s in range(len(lab)):
        want = ref.expand_labels(lab[s], body[s], thr[s], iterations=4)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
        np.testing.assert_array_equal(cyto[s], np.asarray(ref.tertiary_objects(want, lab[s])))


@pytest.mark.parametrize("radius", [1, 3])
def test_grey_disk_exact(sites, radius):
    img = sites[0][..., 0]
    for op, jop in (("min", jax.lax.min), ("max", jax.lax.max)):
        got = port._grey_disk(torch.from_numpy(img), radius, op).numpy()
        want = np.asarray(jax.vmap(lambda x: ref._grey_disk(x, radius, jop))(jnp.asarray(img)))
        np.testing.assert_array_equal(got, want)


def test_granularity_spectrum_close(sites):
    img = np.ascontiguousarray(sites[0][..., 0])
    kw = dict(spectrum_length=6, subsample_size=0.5, image_sample_size=0.5, element_size=3)
    got = port.granularity_spectrum_cp(torch.from_numpy(img), **kw).numpy()
    for s in range(len(img)):
        want = np.asarray(ref.granularity_spectrum_cp(img[s], **kw))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("length", [8, 16])
def test_legacy_granularity_spectrum_matches_reference(sites, length):
    """Within 1e-6 of the spectrum's largest element: each element is the
    difference of two f32 image means, summed in another order on each side
    (where the exact value is 0 the reference gives about -1e-6)."""
    img = np.ascontiguousarray(sites[0][..., 0])
    got = port.granularity_spectrum(torch.from_numpy(img), length).numpy()
    assert got.shape == (len(img), length)
    for s in range(len(img)):
        want = np.asarray(ref.granularity_spectrum(jnp.asarray(img[s]), length))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_legacy_granularity_spectrum_shape():
    """The reference's shape and monotonicity check
    (``tests/test_features.py``) on the port: fine noise loses most of its
    volume at small radii."""
    rng = np.random.default_rng(0)
    img = rng.random((2, 64, 64)).astype(np.float32)
    g = port.granularity_spectrum(torch.from_numpy(img), 8).numpy()
    assert g.shape == (2, 8)
    assert np.isfinite(g).all()
    assert (g[:, 0] > g[:, -1]).all()


# ---------------------------------------------------------------------------
# K8's schedule, modelled in NumPy


def _scan_tile(r, c):
    """The kernel's in-tile relaxation of a staged tile ``r`` (its 1-pixel
    halo included) under the ceiling ``c``: line scans left, right, down,
    up, in place, until four scans in a row raise nothing. Returns whether
    a pixel rose."""
    t_h, t_w = c.shape
    moved, quiet, d = False, 0, 0
    while quiet < 4:
        old = r.copy()
        if d < 2:
            xs = range(t_w) if d == 0 else range(t_w - 1, -1, -1)
            v = r[1:-1, 0] if d == 0 else r[1:-1, -1]
            for x in xs:
                v = np.minimum(np.maximum(r[1:-1, x + 1], v), c[:, x])
                r[1:-1, x + 1] = v
        else:
            ys = range(t_h) if d == 2 else range(t_h - 1, -1, -1)
            v = r[0, 1:-1] if d == 2 else r[-1, 1:-1]
            for y in ys:
                v = np.minimum(np.maximum(r[y + 1, 1:-1], v), c[y, :])
                r[y + 1, 1:-1] = v
        up = bool((r > old).any())
        quiet = 0 if up else quiet + 1
        moved |= up
        d = (d + 1) % 4
    return moved


def _model_reconstruct(seed, ceiling, tile, order, rng=None):
    """K8's reconstruction schedule on (B, H, W) f32 planes: in each grid
    round every marked tile (all in the first) is staged with its halo from
    the current state (``order="inplace"``, tiles in a random order as the
    card's warps interleave) or from the round's first state (``"jacobi"``),
    scanned to local stability and written back; each side that rose marks
    the neighbour across it. Ends after a round that marks nothing. Returns
    (r, rounds)."""
    r = seed.copy()
    b, h, w = r.shape
    ty, tx = -(-h // tile), -(-w // tile)
    cpad = np.full((b, ty * tile, tx * tile), -np.inf, np.float32)
    cpad[:, :h, :w] = ceiling
    marked = {(p, i, j) for p in range(b) for i in range(ty) for j in range(tx)}
    rounds = 0
    while marked:
        rounds += 1
        src = r.copy() if order == "jacobi" else r
        seq = sorted(marked)
        if rng is not None:
            rng.shuffle(seq)
        marked = set()
        for p, i, j in seq:
            y0, x0 = i * tile, j * tile
            st = np.full((tile + 2, tile + 2), -np.inf, np.float32)
            ys, xs = slice(max(y0 - 1, 0), min(y0 + tile + 1, h)), slice(max(x0 - 1, 0), min(x0 + tile + 1, w))
            st[ys.start - y0 + 1 : ys.stop - y0 + 1, xs.start - x0 + 1 : xs.stop - x0 + 1] = src[p, ys, xs]
            st[1:-1, 1:-1][: min(tile, h - y0), : min(tile, w - x0)] = r[p, y0 : y0 + tile, x0 : x0 + tile]
            for corner in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
                st[corner] = -np.inf
            before = st.copy()
            if not _scan_tile(st, cpad[p, y0 : y0 + tile, x0 : x0 + tile]):
                continue
            r[p, y0 : y0 + tile, x0 : x0 + tile] = st[1:-1, 1:-1][: min(tile, h - y0), : min(tile, w - x0)]
            for rose, (ni, nj) in (((st[1] > before[1]).any(), (i - 1, j)),
                                   ((st[-2] > before[-2]).any(), (i + 1, j)),
                                   ((st[:, 1] > before[:, 1]).any(), (i, j - 1)),
                                   ((st[:, -2] > before[:, -2]).any(), (i, j + 1))):
                if rose and 0 <= ni < ty and 0 <= nj < tx:
                    marked.add((p, ni, nj))
    return r, rounds


def _model_spectrum(pixels, length, tile):
    """K8's spectrum on the model: per scale the cross erosion, the
    schedule's reconstruction, each tile's sum of (prev - rec) in f64 (each
    difference rounded to f32) and the planes' sums of the tiles' in tile
    order, divided as the plain form divides."""
    b, h, w = pixels.shape
    ty, tx = -(-h // tile), -(-w // tile)

    def tile_sums(a):
        return np.array([[a[p, i * tile : (i + 1) * tile, j * tile : (j + 1) * tile].astype(np.float64).sum()
                          for i in range(ty) for j in range(tx)] for p in range(b)])

    n = float(h * w)
    denom = np.maximum((tile_sums(pixels).sum(axis=1) / n).astype(np.float32), np.float32(np.finfo(np.float64).eps))
    ero, prev, out = pixels, pixels, []
    for _ in range(length):
        ero = port._cross(torch.from_numpy(ero), "min").numpy()
        rec, _ = _model_reconstruct(ero, pixels, tile, "inplace", np.random.default_rng(len(out)))
        mean = (tile_sums(prev - rec).sum(axis=1) / n).astype(np.float32)
        out.append(mean * np.float32(100.0) / denom)
        prev = rec
    return np.stack(out, axis=1)


def _plane(kind, shape, seed):
    """A (1, H, W) ceiling and the seed to reconstruct from: random grey
    levels; rounded blobs (plateaus and ties); or a spiral path rising
    along its length, seeded at its start only."""
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "random":
        c = (rng.random((1, h, w)) * 1000).astype(np.float32)
    elif kind == "plateaus":
        yy, xx = np.mgrid[:h, :w]
        c = np.zeros((h, w))
        for _ in range(8):
            cy, cx, rad = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 12)
            c += 60 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rad**2)
        c = np.round(c / 7)[None].astype(np.float32)
    else:
        path = spiral_path(h)
        c = np.where(path, 50.0 + np.cumsum(path).reshape(h, w) * 1e-3, 0.0)[None].astype(np.float32)
        seed_plane = np.zeros_like(c)
        seed_plane[0, 0, 0] = c[0, 0, 0]
        return c, seed_plane
    return c, port._cross(port._cross(torch.from_numpy(c), "min"), "min").numpy()


MODEL_SHAPES = [(1, 1), (1, 300), (33, 270), (270, 270), (31, 65)]


@pytest.mark.parametrize("order", ["inplace", "jacobi"])
@pytest.mark.parametrize("kind,shape", [(k, s) for k in ("random", "plateaus") for s in MODEL_SHAPES]
                         + [("spiral", (70, 70))])
def test_k8_schedule_reconstructs_bit_for_bit(kind, shape, order):
    """The kernel's schedule (32-pixel tiles, which divide none of these
    sides) reaches ``_reconstruct_cross_unit``'s fixpoint exactly, whether
    tiles see the halo their neighbours wrote earlier in the round or the
    round's first state; on the spiral the value runs through every tile
    many times."""
    ceiling, seed = _plane(kind, shape, seed=sum(shape))
    want = port._reconstruct_cross_unit(torch.from_numpy(seed), torch.from_numpy(ceiling)).numpy()
    got, rounds = _model_reconstruct(seed, ceiling, segment_cuda.K8_TILE, order, np.random.default_rng(1))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if kind == "spiral":
        assert rounds > 20 and (want > 0).sum() == spiral_path(shape[0]).sum()


@pytest.mark.parametrize("shape", [(31, 65), (70, 70)])
def test_k8_schedule_spectrum_close_to_plain(sites, shape):
    """The model's spectrum (tile sums in f64, planes' sums in tile order)
    against ``granularity_spectrum_cp`` on the CPU within rtol 1e-5: only
    the order of the per-plane sums differs."""
    img = np.ascontiguousarray(np.moveaxis(sites[0], -1, 1).reshape(-1, *sites[0].shape[1:3]))
    img = np.ascontiguousarray(np.resize(img, (img.shape[0], *shape)))
    kw = dict(subsample_size=0.5, image_sample_size=0.5, element_size=3)
    want = port.granularity_spectrum_cp(torch.from_numpy(img), 8, **kw).numpy()
    pixels = port.granularity_pixels(torch.from_numpy(img), **kw).numpy()
    got = _model_spectrum(pixels, 8, segment_cuda.K8_TILE)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_granularity_on_cpu_takes_the_plain_loop(sites):
    """A CPU tensor runs the plain loop and never the kernel: the spectrum
    is the plain form's on the background-removed planes, bit for bit, and
    K8 counts no launch."""
    img = np.ascontiguousarray(sites[0][..., 1])
    kw = dict(subsample_size=0.5, image_sample_size=0.5, element_size=3)
    before = segment_cuda.LAUNCHES["sag_granularity"]
    got = port.granularity_spectrum_cp(torch.from_numpy(img), 5, **kw)
    plain = port.granularity_scales_plain(port.granularity_pixels(torch.from_numpy(img), **kw), 5)
    assert torch.equal(got, plain)
    assert segment_cuda.LAUNCHES["sag_granularity"] == before == 0
