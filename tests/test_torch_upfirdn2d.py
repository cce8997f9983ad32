"""FIR resampling parity: use_tpu_torch.ops.upfirdn2d (NCHW depthwise torch
convs) against use_tpu.ops.upfirdn2d (NHWC XLA convs), atol 1e-6."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import nchw_to_nhwc, nhwc_to_nchw

jfir = importlib.import_module("use_tpu.ops.upfirdn2d")
tfir = importlib.import_module("use_tpu_torch.ops.upfirdn2d")
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed=0, shape=(2, 8, 12, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "up,down,pad",
    # (2, 1, (2, 1)) and (1, 2, (1, 1)) are what NCSN++'s FIR up/down use
    [(2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (1, 2)), (2, 2, (0, 3)), (3, 1, (-1, 2))],
)
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x()
    kern = jfir.setup_kernel((1.0, 3.0, 3.0, 1.0))
    kern = kern * np.arange(1, 17, dtype=np.float32).reshape(4, 4)  # asymmetric: catches a missing flip
    want = np.asarray(jfir.upfirdn2d(jnp.asarray(x), kern, up=up, down=down, pad=pad))
    got = tfir.upfirdn2d(nhwc_to_nchw(x), kern, up=up, down=down, pad=pad)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, atol=ATOL)


def test_fir_upsample_downsample_match_jax():
    x = _x(1)
    k = (1.0, 3.0, 3.0, 1.0)
    up_t = tfir.upsample_2d(nhwc_to_nchw(x), k, factor=2)
    np.testing.assert_allclose(nchw_to_nhwc(up_t), np.asarray(jfir.upsample_2d(jnp.asarray(x), k, 2)),
                               atol=ATOL)
    assert up_t.shape == (2, 3, 16, 24)
    down_t = tfir.downsample_2d(nhwc_to_nchw(x), k, factor=2)
    np.testing.assert_allclose(nchw_to_nhwc(down_t),
                               np.asarray(jfir.downsample_2d(jnp.asarray(x), k, 2)), atol=ATOL)
    assert down_t.shape == (2, 3, 4, 6)
    np.testing.assert_array_equal(tfir.setup_kernel(k), jfir.setup_kernel(k))


def test_naive_resample_matches_jax():
    x = _x(2)
    up = tfir.naive_upsample_2d(nhwc_to_nchw(x), 2)
    np.testing.assert_array_equal(nchw_to_nhwc(up), np.asarray(jfir.naive_upsample_2d(jnp.asarray(x), 2)))
    down = tfir.naive_downsample_2d(nhwc_to_nchw(x), 2)
    np.testing.assert_allclose(nchw_to_nhwc(down),
                               np.asarray(jfir.naive_downsample_2d(jnp.asarray(x), 2)), atol=ATOL)
