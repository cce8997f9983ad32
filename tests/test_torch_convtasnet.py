"""ConvTasNet in use_tpu_torch against use_tpu's, on the CPU.

Narrow widths (enc_dim 16, feature_dim 8, 3 layers x 2 stacks), gLN and
the causal cumulative norm, lengths on and off a multiple of the window,
fs 8 kHz (window 16) and 24 kHz (window 48), and a quiet input, where
gLN's variance (Flax's E[x^2] - E[x]^2, eps 1e-8) is small. Weights are
use_tpu's random params carried by engine/convert_jax.py (strict load).
Tolerance: the waveform within 1e-5 of its largest |value| (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.models.convtasnet import ConvTasNet as JConvTasNet
from use_tpu_torch.engine.convert_jax import convtasnet_params_to_state_dict
from use_tpu_torch.models.convtasnet import ConvTasNet
from use_tpu_torch.models.registry import BackboneRegistry

TINY = dict(enc_dim=16, feature_dim=8, layer=3, stack=2)
TOL = 1e-5
CASES = [  # (fs, causal, length, amplitude)
    (8000, False, 1600, 0.3),  # a multiple of the window (16)
    (8000, False, 1603, 0.3),
    (24000, True, 2400, 0.3),  # a multiple of the window (48)
    (24000, True, 2417, 0.3),
    (24000, False, 2401, 0.3),
    (8000, True, 1601, 0.3),
    (8000, False, 1611, 1e-4),  # quiet
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("fs,causal,length,amplitude", CASES,
                         ids=[f"{fs // 1000}k-{'causal' if c else 'gln'}-{n}-{a:g}"
                              for fs, c, n, a in CASES])
def test_convtasnet_matches_jax(fs, causal, length, amplitude):
    x = (amplitude * np.random.default_rng(length).standard_normal((2, length))
         ).astype(np.float32)
    jm = JConvTasNet(fs=fs, causal=causal, **TINY)
    params = random_params(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                          jnp.asarray(x))["params"], seed=length)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x)))
    tm = BackboneRegistry.get_by_name("convtasnet")(fs=fs, causal=causal, **TINY)
    assert isinstance(tm, ConvTasNet) and tm.win == int(fs * 2 / 1000)
    tm.load_state_dict(convtasnet_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, length)
    assert _rel(got, want) <= TOL


def test_convtasnet_default_init_is_flax_like():
    """The seeded init: PReLU slopes 0.01 (Flax's, one each), norms 1 / 0,
    no bias on the encoder and decoder, the same weights for the same seed."""
    a, b = ConvTasNet(**TINY, seed=3), ConvTasNet(**TINY, seed=3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert a.encoder.bias is None and a.decoder.bias is None
    slopes = [v for k, v in a.state_dict().items() if "PReLU" in k]
    assert slopes and all(v.shape == (1,) and float(v) == pytest.approx(0.01) for v in slopes)
