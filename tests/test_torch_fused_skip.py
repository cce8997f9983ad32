"""Fused resblock shortcut (kernel K2) parity: the port's plain version
against use_tpu's Pallas kernel run in interpret mode on the CPU and against
its XLA formulation reference_skip_add. fp32 atol 1e-5; bf16 atol 0.05."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import nchw_to_nhwc, nhwc_to_nchw
from use_tpu.ops import pallas_skip as ps
from use_tpu_torch.ops.fused_skip import fused_skip_add, fused_skip_add_plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_xla(dtype, monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 32, 64)).astype(np.float32)  # NHWC, Ci 64
    h = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)  # Co 32
    w = (0.1 * rng.standard_normal((64, 32))).astype(np.float32)  # [Ci, Co]
    b = (0.1 * rng.standard_normal((32,))).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # round the inputs to the working dtype once, so both sides see the same values
    xj, hj, wj, bj = (jnp.asarray(a, jdt) for a in (x, h, w, b))
    x, h, w, b = (np.array(a, np.float32) for a in (xj, hj, wj, bj))

    monkeypatch.setattr(ps.pl, "pallas_call", functools.partial(ps.pl.pallas_call, interpret=True))
    scale = 2 ** -0.5
    want_pallas = np.asarray(ps.fused_skip_add(xj, hj, wj, bj, scale=scale, tile_h=2), np.float32)
    want_xla = np.asarray(ps.reference_skip_add(xj, hj, wj, bj, scale=scale), np.float32)

    got = fused_skip_add(nhwc_to_nchw(x).to(tdt), nhwc_to_nchw(h).to(tdt),
                         torch.from_numpy(w.T.copy()).to(tdt), torch.from_numpy(b).to(tdt), scale)
    assert got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(nchw_to_nhwc(got), want_pallas, atol=atol)
    np.testing.assert_allclose(nchw_to_nhwc(got), want_xla, atol=atol)


def test_plain_accepts_conv_weight_and_rejects_bad_shapes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 8, 3, 5)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((1, 4, 3, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.zeros(4)
    ref = torch.nn.functional.conv2d(x, w[:, :, None, None], b) + h
    torch.testing.assert_close(fused_skip_add_plain(x, h, w[:, :, None, None], b), ref,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        fused_skip_add(x, h, w.T.contiguous(), b)
    with pytest.raises(ValueError):
        fused_skip_add(x.to("meta"), h.to("meta"), w.to("meta"), b.to("meta"))
