"""The LSGAN discriminator bank of use_tpu_torch against use_tpu's, on the CPU.

The shipped composite (hifigan_vocoder_discriminator_24k_MVD: the period
bank at 2/3/5/7/11, the wave bank at 8/12/16/24 kHz, the mel bank at three
resolutions) gets use_tpu's Flax params, converted by
engine/convert_jax.py::discriminator_params_to_state_dict, and a 0.2 s clip
(4001 samples): shorter than every wave discriminator's least input and
the mel discriminators' least frame count, so use_tpu's zero and
log-silence pads are taken, and not a multiple of any period, so the
reflect pad of the fold is taken too. Every logit and every feature map is
compared, use_tpu's NHWC / NWC maps transposed to NCHW / NCW.
Tolerance: each tensor within 1e-5 of its own largest |value| (fp32; the
frameworks sum convolutions in other orders), the mel bank's within 1e-4:
its log-mel input comes through use_tpu's matmul DFT on one side and an
FFT on the other, and its logit is a mean of a map that cancels to ~1/30
of the map's scale (readings up to 2.1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.models.gan.discriminators import (
    HifiganVocoderDiscriminator24kMVD as JMVD,
    WaveDiscriminator as JWave,
)
from use_tpu_torch.engine.convert_jax import discriminator_params_to_state_dict
from use_tpu_torch.models.gan import discriminators as tdisc
from use_tpu_torch.models.registry import DiscriminatorRegistry

LENGTH = 4001
BANKS = {"MPD": [2, 3, 5, 7, 11], "MVD": [8000, 12000, 16000, 24000], "MMD": [0, 1, 2]}
CASES = [(b, i) for b, names in enumerate(BANKS.values()) for i in range(len(names))]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_nchw(a):
    a = np.asarray(a)
    return np.moveaxis(a, -1, 1)  # NHWC / NWC -> NCHW / NCW


@pytest.fixture(scope="module")
def both():
    """use_tpu's and the port's composite on one set of random params and
    one clip; -> (params, port module, (jax logits, maps), (port logits, maps))."""
    x = (0.3 * np.random.default_rng(0).standard_normal((2, LENGTH))).astype(np.float32)
    jd = JMVD()
    params = random_params(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(x))
                           ["params"], seed=1)
    want = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    td = DiscriminatorRegistry.get_by_name("hifigan_vocoder_discriminator_24k_MVD")(seed=0)
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    return params, td, want, got


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("bank,disc", CASES, ids=[f"{b}-{n}" for b, names in BANKS.items()
                                                  for n in names])
def test_sub_discriminator_logits_and_maps_match_jax(both, bank, disc):
    _, _, (lj, fj), (lt, ft) = both
    tol = 1e-4 if bank == 2 else 1e-5
    got, want = lt[bank][disc].numpy(), np.asarray(lj[bank][disc])
    assert got.shape == want.shape
    assert _rel(got, want) <= tol
    assert len(ft[bank][disc]) == len(fj[bank][disc])
    for g, w in zip(ft[bank][disc], fj[bank][disc]):
        w = _to_nchw(w)
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) <= tol


def test_composite_structure_and_min_length_pads(both):
    """[bank][disc] lists; the wave and mel maps of a 0.2 s clip are not
    empty (padded to the least input), the period logits the fold's
    frames, one longer for the even conv_post kernel."""
    _, td, _, (lt, ft) = both
    assert [len(b) for b in lt] == [5, 4, 3] and [len(b) for b in ft] == [5, 4, 3]
    assert all(lg.shape == (2, 1) for lg in lt[1] + lt[2])
    for p, lg, fm in zip(BANKS["MPD"], lt[0], ft[0]):
        frames = -(-LENGTH // p)  # reflect-padded to a multiple of the period
        for scale in (3, 3, 3, 3, 1):
            frames = (frames + 2 * 2 - 5) // scale + 1
        assert tuple(fm[-1].shape) == (2, 1, frames + 1, p) and lg.shape == (2, (frames + 1) * p)
    assert all(t.numel() > 0 for b in ft for d in b for t in d)
    assert all(td.MVD.discs[i].min_len > LENGTH * sr / 24000
               for i, sr in enumerate(BANKS["MVD"]))


def test_discriminator_params_round_trip(both):
    """use_tpu params -> the port's state_dict: every leaf once, at its
    transposed shape, and back by the inverse transposition array for array."""
    params, td, _, _ = both
    state = discriminator_params_to_state_dict(params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert len(flat) == len(state) == len(td.state_dict())
    for path, arr in flat.items():
        name = path.replace("/", ".").replace(".kernel", ".weight")
        back = state[name].numpy()
        if arr.ndim == 4:
            back = np.transpose(back, (2, 3, 1, 0))
        elif arr.ndim == 3:
            back = np.transpose(back, (2, 1, 0))
        np.testing.assert_array_equal(back, arr)


def test_wave_discriminator_without_pad_matches_jax():
    """A 24 kHz wave discriminator on a clip longer than its least input
    (no pad), at an odd length."""
    x = (0.3 * np.random.default_rng(2).standard_normal((1, 5301))).astype(np.float32)
    jd = JWave(sample_rate=24000)
    params = random_params(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(x))
                           ["params"], seed=3)
    lj, fj = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    td = tdisc.WaveDiscriminator(sample_rate=24000)
    assert 5301 > td.min_len
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        lt, ft = td(torch.from_numpy(x))
    assert _rel(lt.numpy(), np.asarray(lj)) <= 1e-5
    for g, w in zip(ft, fj):
        assert _rel(g.numpy(), _to_nchw(w)) <= 1e-5


def test_seeded_initialization():
    """One seed, one D; Flax's defaults: zero biases, kernels of variance
    1 / fan_in truncated at two standard deviations."""
    a, b = tdisc.MultiPeriodDiscriminator(periods=(2, 3)), tdisc.MultiPeriodDiscriminator((2, 3))
    for m in (a, b):
        tdisc.reset_parameters(m, torch.Generator().manual_seed(4))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    w = a.period2.conv1.weight.detach()
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.05
    assert not a.period2.conv1.bias.any()
