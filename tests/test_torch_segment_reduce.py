"""Perimeter weights and Euler numbers: the port against the reference,
exactly (Euler contributions are small integers; perimeter weights are
predicates times three constants)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import segment_reduce as ref
from saguaro_tpu_torch.kernels import segment_reduce as port

from .torch_data import blob_sites


@pytest.fixture(scope="module")
def labels():
    _, lab = blob_sites(n_sites=2, h=48, w=56, n_ch=1, n_cells=7, seed=5)
    return lab


def test_perimeter_weights_exact(labels):
    w_got, b_got = port.perimeter_weight_image(torch.from_numpy(labels))
    for s in range(len(labels)):
        w_want, b_want = ref.perimeter_weight_image(jnp.asarray(labels[s]))
        np.testing.assert_array_equal(b_got[s].numpy(), np.asarray(b_want))
        np.testing.assert_array_equal(w_got[s].numpy(), np.asarray(w_want))


@pytest.mark.parametrize("max_cells", [8, 64])
def test_euler_numbers_exact(labels, max_cells):
    got = port.euler_numbers(torch.from_numpy(labels), max_cells).numpy()
    want = np.asarray(jax.vmap(lambda lb: ref.euler_numbers(lb, max_cells))(jnp.asarray(labels)))
    np.testing.assert_array_equal(got, want)
    # object 1 carries a hole: Euler number 0
    assert got[0, 1] == 0.0 and got[0, 2] == 1.0
