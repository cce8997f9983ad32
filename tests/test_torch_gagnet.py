"""GaGNet in use_tpu_torch against use_tpu's, on the CPU.

Tiny widths (c 8, cd1 8, d_feat 32, a few TCMs, T 6-8 frames) in six cases
that take every option at least once: the U^2 encoder and the plain one,
causal and not, squeezed and not, the sigmoid / tanh / relu gains, 'cat'
and 'add' intra connections; with the U^2 encoder F 161 and 256 (padded to
257), without it F 33 (where the encoder ends at width 0, as XLA's VALID
conv leaves it) and 64 (padded to 65), where use_tpu runs. Weights
are use_tpu's random params carried by engine/convert_jax.py (a strict
load, so the converter covers every parameter). Tolerance: the output
within 1e-3 of its largest |value|. Not 1e-5: these random nets amplify
fp32 rounding (instance norms over a few frames, random PReLU slopes), so
that the port's own float64 forward differs from its float32 one by up to
2.1e-4 of max|out| (F161, CPU), as much as use_tpu's float32 forward does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.models.gagnet import GaGNet as JGaGNet
from use_tpu_torch.engine.convert_jax import flax_params_to_state_dict
from use_tpu_torch.models.gagnet import GaGNet, GlanceGazeModule
from use_tpu_torch.models.registry import BackboneRegistry

TINY = dict(c=8, cd1=8, d_feat=32)
TOL = 1e-3
CASES = [  # (freqs, frames, options)
    (161, 7, dict(is_u2=True, causal=True, is_squeezed=False, acti_type="sigmoid",
                  intra_connect="cat", p=1, q=2, dilas=(1, 2))),
    (256, 6, dict(is_u2=True, causal=False, is_squeezed=True, acti_type="tanh",
                  intra_connect="add", p=1, q=1, dilas=(1, 3))),
    (161, 8, dict(is_u2=True, causal=False, is_squeezed=False, acti_type="relu",
                  intra_connect="add", p=1, q=1, dilas=(2,))),
    (33, 8, dict(is_u2=False, causal=True, is_squeezed=True, acti_type="relu",
                 intra_connect="cat", p=2, q=2, dilas=(1, 2))),
    (64, 7, dict(is_u2=False, causal=False, is_squeezed=False, acti_type="sigmoid",
                 intra_connect="cat", p=1, q=2, dilas=(1, 4))),
    (256, 8, dict(is_u2=True, causal=True, is_squeezed=True, acti_type="tanh",
                  intra_connect="cat", p=1, q=1, dilas=(1,))),
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


def _spec(seed, f, t):
    return (0.5 * np.random.default_rng(seed).standard_normal((2, f, t, 2))).astype(np.float32)


def _pair(kw, x, seed):
    """use_tpu's GaGNet on random params and its output; the port's with
    those params."""
    jm = JGaGNet(**TINY, **kw)
    params = random_params(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), x)
                           ["params"], seed=seed)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x)))
    tm = GaGNet(**TINY, **kw, seed=1)
    tm.materialize(x.shape[1] + (x.shape[1] + 1) % 2)
    tm.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return params, want, tm


@pytest.mark.parametrize("freqs,frames,kw", CASES,
                         ids=[f"F{f}-{'u2' if k['is_u2'] else 'unet'}-{k['acti_type']}"
                              f"-{k['intra_connect']}" for f, _, k in CASES])
def test_gagnet_matches_jax(freqs, frames, kw):
    x = _spec(freqs, freqs, frames)
    _, want, tm = _pair(kw, x, seed=freqs + frames)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, freqs, frames, 1, 2)
    assert _rel(got, want) <= TOL


def test_gagnet_is_masking():
    """A zero spectrum gives exactly zero (a pure complex mask), as
    tests/test_alt_backbones.py::test_gagnet_is_masking holds use_tpu's."""
    net = BackboneRegistry.get_by_name("gagnet")(c=8, cd1=8, d_feat=32, p=1, q=1, dilas=(1,),
                                                 fft_num=64, is_u2=False)
    with torch.no_grad():
        out = net(torch.zeros(1, 33, 8, 2))
    assert out.shape == (1, 33, 8, 1, 2)
    assert torch.count_nonzero(out) == 0


def test_gagnet_converter_flips_and_flatten_orders_matter():
    """The parity above depends on each of the converter's and the port's
    orders: with the transposed convs' taps left unflipped, or the heads'
    input rows taken in another flatten order (the encoder's channels slow,
    or real / imag slow), the output leaves the tolerance by far."""
    freqs, frames, kw = CASES[0]
    x = _spec(3, freqs, frames)
    params, want, tm = _pair(kw, x, seed=5)
    state = flax_params_to_state_dict(params)

    def err_with(edit):
        net = GaGNet(**TINY, **kw)
        net.materialize(freqs)
        net.load_state_dict({k: edit(k, v) for k, v in state.items()}, strict=True)
        with torch.no_grad():
            return _rel(net(torch.from_numpy(x)).numpy(), want)

    assert err_with(lambda k, v: v) <= TOL
    assert err_with(lambda k, v: v.flip(2, 3) if "ConvTranspose_0.weight" in k else v) > 100 * TOL

    ff = tm.gag0.glance.in_main.weight.shape[1] - 2 * freqs  # the encoder's C x F' rows
    feat_c = 64

    def c_slow(k, v):  # the encoder's rows as [C, F'] flattened, C slowest
        if not k.endswith(("in_main.weight", "in_gate.weight")):
            return v
        rows = torch.arange(ff).reshape(ff // feat_c, feat_c).t().reshape(-1)
        return torch.cat([v[:, rows], v[:, ff:]], dim=1)

    def ri_slow(k, v):  # the spectrum's rows as [2, F], real / imag slowest
        if not k.endswith(("in_main.weight", "in_gate.weight")):
            return v
        rows = torch.arange(2 * freqs).reshape(freqs, 2).t().reshape(-1)
        return torch.cat([v[:, :ff], v[:, ff:][:, rows]], dim=1)

    assert err_with(c_slow) > 100 * TOL
    assert err_with(ri_slow) > 100 * TOL
    assert isinstance(tm.gag1, GlanceGazeModule)


def test_gagnet_fails_where_use_tpu_fails():
    """F 515 with the U^2 encoder: an even width inside an intra-U-Net, so
    the residual add fails on shapes in both packages (the port pads no
    way around it)."""
    x = _spec(0, 515, 6)
    jm = JGaGNet(**TINY, p=1, q=1, dilas=(1,))
    with pytest.raises(Exception):
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.asarray(x))
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            GaGNet(**TINY, p=1, q=1, dilas=(1,))(torch.from_numpy(x))
