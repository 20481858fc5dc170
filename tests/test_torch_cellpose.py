"""CPnet and its tiled inference: the port against the flax reference with
the same weights (bridged from the flax tree), in f32 on both sides.
Network outputs agree to 1e-4 (f32 convolutions summed in other orders);
the antialiased bilinear rescale and the taper merge keep flows and
cellprob within the same tolerance; the nearest label upsample and the
tile grid are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.models import cellpose as ref
from saguaro_tpu_torch.models import cellpose as port
from saguaro_tpu_torch.models.weights import cellpose_name_map, cellpose_state_dict_from_flax

from .torch_data import share_cpu_threads

share_cpu_threads()

FEATURES = (8, 16, 32, 64)


def randomize_bn(variables, seed):
    """flax variables (numpy) with non-trivial BatchNorm affine and stats."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda x: np.array(x), variables)

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                d[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                d[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "scale":
                d[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    walk(out)
    return out


@pytest.fixture(scope="module")
def nets():
    cfg_ref = ref.CellposeConfig(features=FEATURES, tile=64, compute_dtype="float32")
    model, variables = ref.init_cellpose(cfg_ref, seed=0)
    variables = randomize_bn(variables, 1)
    cfg = port.CellposeConfig(features=FEATURES, tile=64, compute_dtype="float32")
    net = port.CellposeUNet(cfg)
    missing, unexpected = net.load_state_dict(cellpose_state_dict_from_flax(variables, cfg), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model, variables, cfg_ref, net.eval(), cfg


def test_name_map_covers_both_models(nets):
    model, variables, _, net, cfg = nets
    from saguaro_tpu.models.weights import flatten_tree

    m = cellpose_name_map(cfg)
    assert set(m) == set(flatten_tree(variables))
    sd_keys = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(m.values()) == sd_keys


def test_unet_matches_flax(nets):
    model, variables, _, net, _ = nets
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply(variables, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("at_net", [True, False])
def test_segment_image_batch_matches(nets, at_net):
    model, variables, cfg_ref, net, cfg = nets
    imgs = np.random.default_rng(1).integers(80, 3000, (2, 150, 170, 3)).astype(np.uint16)
    with jax.default_matmul_precision("highest"):
        fw, pw = ref.segment_image_batch(
            model.apply, variables, jnp.asarray(imgs), cfg_ref, diameter=100.0,
            at_network_resolution=at_net, n_seg=2,
        )
    fg, pg = port.segment_image_batch(
        net, torch.from_numpy(imgs.astype(np.int32)), cfg, diameter=100.0,
        at_network_resolution=at_net, n_seg=2,
    )
    fw, pw = np.asarray(fw), np.asarray(pw)
    assert fg.shape == fw.shape and pg.shape == pw.shape
    np.testing.assert_allclose(fg.numpy(), fw, rtol=0, atol=1e-4 * np.abs(fw).max())
    np.testing.assert_allclose(pg.numpy(), pw, rtol=0, atol=1e-4 * np.abs(pw).max())


@pytest.mark.parametrize("at_net", [True, False])
def test_segment_image_matches(nets, at_net):
    """The single-image full pass against the reference's, within the
    batched pass's tolerance."""
    model, variables, cfg_ref, net, cfg = nets
    img = np.random.default_rng(2).integers(80, 3000, (130, 90, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        fw, pw, _ = ref.segment_image(model.apply, variables, img, cfg_ref, diameter=60.0,
                                      at_network_resolution=at_net)
    fg, pg, styles = port.segment_image(net, torch.from_numpy(img), cfg, diameter=60.0,
                                        at_network_resolution=at_net)
    fw, pw = np.asarray(fw), np.asarray(pw)
    assert styles is None and fg.shape == fw.shape and pg.shape == pw.shape
    assert fg.shape[1:] == ((130, 90) if not at_net else port._network_shape(130, 90, cfg, 60.0))
    np.testing.assert_allclose(fg.numpy(), fw, rtol=0, atol=1e-4 * np.abs(fw).max())
    np.testing.assert_allclose(pg.numpy(), pw, rtol=0, atol=1e-4 * np.abs(pw).max())


@pytest.mark.parametrize("n_in,n_out", [(150, 45), (45, 150), (1080, 324), (7, 7)])
def test_bilinear_weights_match_jax_resize(n_in, n_out):
    x = np.random.default_rng(2).normal(size=(1, n_in, 3, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, n_out, 3, 1), "bilinear", precision=jax.lax.Precision.HIGHEST))
    got = port.resize_bilinear(torch.from_numpy(x), (n_out, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(x).max())


@pytest.mark.parametrize("shape", [((45, 51), (150, 170)), ((324, 324), (1080, 1080)), ((5, 9), (4, 20))])
def test_nearest_upsample_exact(shape):
    (h, w), out = shape
    lab = np.random.default_rng(3).integers(0, 50, (2, h, w)).astype(np.int32)
    want = np.asarray(jax.image.resize(jnp.asarray(lab), (2, *out), "nearest"))
    got = port.resize_nearest(torch.from_numpy(lab), out).numpy()
    np.testing.assert_array_equal(got, want)


def test_input_conversion_and_normalization():
    x = np.random.default_rng(4).integers(0, 4000, (2, 30, 40, 3)).astype(np.float32)
    x[1, ..., 1] = 7.0  # a flat channel is zeroed
    conv = port.convert_input(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref.convert_input(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        port.convert_input(torch.from_numpy(x[..., :1]), 2).numpy(),
        np.asarray(ref.convert_input(jnp.asarray(x[..., :1]), 2)),
    )
    got = port.normalize_input(conv).numpy()
    want = np.asarray(ref.normalize_input(jnp.asarray(conv.numpy()), spatial_axes=(1, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[1, ..., 1] == 0.0)


def test_tile_grid_and_network_shape():
    for size, tile in ((324, 224), (224, 224), (100, 224), (1000, 96)):
        assert port._tile_grid(size, tile, 0.1) == ref._tile_grid(size, tile, 0.1)
    assert port._network_shape(1080, 1080, port.CellposeConfig(), 100.0) == ref._network_shape(
        1080, 1080, ref.CellposeConfig(), 100.0
    )
    np.testing.assert_array_equal(port._taper(64), ref._taper(64))


def test_seeded_init_is_deterministic():
    cfg = port.CellposeConfig(features=FEATURES, tile=64)
    a = port.init_cellpose(cfg, seed=3, device="cpu")
    b = port.init_cellpose(cfg, seed=3, device="cpu")
    c = port.init_cellpose(cfg, seed=4, device="cpu")
    sa, sb, sc_ = a.state_dict(), b.state_dict(), c.state_dict()
    key = "downsample.down.res_down_0.conv.conv_0.2.weight"
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc_[key])
