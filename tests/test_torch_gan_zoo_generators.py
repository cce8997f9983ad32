"""The GAN zoo's generators and criteria in use_tpu_torch against use_tpu's,
on the CPU: the HiFi-GAN vocoder (causal and centred, NSF off and on) and
the HiFi-GAN+ bandwidth extender, the plain-LSGAN and content criteria.

Inputs and weights as in tests/test_torch_gan_zoo.py (its helpers); the
generators' waveforms within 1e-5 of their largest (fp32, the NCSN++
parity tolerance's atol), the losses within 1e-6, the content criteria's
log terms within 1e-4 (use_tpu's matmul DFT against an FFT, as
tests/test_torch_discriminators.py argues for the log-mel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from tests.test_torch_gan_zoo import _jax, _rel, _to_ncw, _wav
from use_tpu.models.gan import hifigan_bwe as jbwe, hifigan_vocoder as jvoc, losses as jlosses
from use_tpu_torch.engine.convert_jax import (
    bwe_params_to_state_dict,
    hifigan_generator_params_to_state_dict,
)
from use_tpu_torch.models.gan import hifigan_vocoder as tvoc, losses as tlosses
from use_tpu_torch.models.registry import GeneratorRegistry

VOC = dict(in_channels=8, channels=16, upsample_scales=(4, 2), upsample_kernel_sizes=(8, 4),
           resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3), (1, 2)))
NSF = {"nb_harmonics": 3, "sampling_rate": 24000}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_source_draws(module, params, x):
    """use_tpu's NSF draws of one apply (eager: jax.random.uniform and
    normal recorded as they return) and its output."""
    seen = []
    real_u, real_n = jax.random.uniform, jax.random.normal

    def rec(fn):
        def draw(*a, **kw):
            out = fn(*a, **kw)
            seen.append(np.array(out))
            return out
        return draw

    jax.random.uniform, jax.random.normal = rec(real_u), rec(real_n)
    try:
        y = module.apply({"params": params}, x, rngs={"source": jax.random.PRNGKey(3)})
    finally:
        jax.random.uniform, jax.random.normal = real_u, real_n
    phase, noise = seen
    phase[:, :, 0] = 0.0  # as use_tpu sets it after the draw
    return (torch.from_numpy(np.moveaxis(phase, -1, 1).copy()),
            torch.from_numpy(np.moveaxis(noise, -1, 1).copy())), y


@pytest.mark.parametrize("nsf", [False, True], ids=["nsf_off", "nsf_on"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "centred"])
def test_hifigan_generator_matches_jax(causal, nsf):
    """Narrow widths, two stages (x4 by a kernel-8 transposed conv, x2 by a
    kernel-4 one: both trims taken), odd frames; with NSF, pitch and voicing
    as two more input channels and use_tpu's draws passed in."""
    kw = dict(VOC, causal=causal, nsf_params=NSF if nsf else None)
    frames, ch = 13, VOC["in_channels"] + (2 if nsf else 0)
    x = _wav(10, (2, frames, ch), 1.0)
    if nsf:
        rng = np.random.default_rng(11)
        x[..., -2] = rng.uniform(80, 300, (2, frames))  # pitch, Hz
        x[..., -1] = (rng.uniform(size=(2, frames)) > 0.3)  # voiced
    jm = jvoc.HifiganGenerator(**kw)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "source": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    params = random_params(shapes["params"], seed=12)
    tm = GeneratorRegistry.get_by_name("hifigan_generator")(**kw)
    tm.load_state_dict(hifigan_generator_params_to_state_dict(params), strict=True)
    draws = None
    if nsf:
        draws, want = _jax_source_draws(jm, params, jnp.asarray(x))
    else:
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(_to_ncw(x)).contiguous(), source_draws=draws)
    assert tuple(got.shape) == (2, frames * 8)
    assert _rel(got.numpy(), want) <= 1e-5


def test_hifigan_generator_draws_its_own_source():
    """Without draws given, one seed, one excitation; another seed, another."""
    tm = tvoc.HifiganGenerator(**VOC, nsf_params=NSF)
    x = torch.from_numpy(_to_ncw(_wav(13, (1, 9, VOC["in_channels"] + 2), 1.0))).contiguous()
    x[:, -2] = 150.0
    x[:, -1] = 1.0
    with torch.no_grad():
        a, b, c = (tm(x, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_hifigan_generator_transposed_kernels_are_flipped():
    """The converter reverses a transposed conv's taps and lays it out
    [I, O, k]; every other kernel [O, I, k]."""
    tm = tvoc.HifiganGenerator(**VOC)
    params = random_params(jax.eval_shape(jvoc.HifiganGenerator(**VOC).init,
                                          jax.random.PRNGKey(0),
                                          jnp.zeros((1, 5, VOC["in_channels"])))["params"], 14)
    state = hifigan_generator_params_to_state_dict(params)
    k = np.asarray(params["transpose_up0"]["ConvTranspose_0"]["kernel"])  # [k, I, O]
    np.testing.assert_array_equal(state["transpose_up0.ConvTranspose_0.weight"].numpy(),
                                  np.transpose(k[::-1], (1, 2, 0)))
    assert set(state) == set(tm.state_dict())


@pytest.mark.parametrize("source_rate", [8000, 24000])
def test_bandwidth_extender_matches_jax(source_rate):
    """The default WaveNet (2 stacks x 8 layers, 128 channels, 6,560
    samples of zero pad a side) on a clip of 0.04 s; at 8 kHz through the
    kaiser-sinc resample, at 24 kHz without."""
    x = _wav(15, (1, int(0.04 * source_rate)))
    jm = jbwe.BandwidthExtender()
    params, want = _jax(jm, jnp.asarray(x), 16, source_rate)
    tm = GeneratorRegistry.get_by_name("hifigan_bwe")()
    assert tm.WaveNet_0.receptive_field // 2 == 6560
    tm.load_state_dict(bwe_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), source_rate)
    assert tuple(got.shape) == (1, 960)
    assert _rel(got.numpy(), want) <= 1e-5


def _logits(seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, n)).astype(np.float32) for n in (7, 5)],
            [rng.standard_normal((2, 1)).astype(np.float32)]]


def test_lsgan_losses_match_jax():
    """Summed over discriminators, not averaged: the values, and G's
    gradient into the fake logits."""
    fake, real = _logits(17), _logits(18)
    jb = {"predicted_fake_logits": jax.tree.map(jnp.asarray, fake),
          "predicted_clean_logits": jax.tree.map(jnp.asarray, real)}
    tb = {"predicted_fake_logits": [[torch.from_numpy(a).requires_grad_(True) for a in b]
                                    for b in fake],
          "predicted_clean_logits": jax.tree.map(torch.from_numpy, real)}
    g_t, d_t = tlosses.lsgan_g_loss(tb)["loss_G"], tlosses.lsgan_d_loss(tb)["loss_D"]
    g_j, d_j = jlosses.lsgan_g_loss(jb)["loss_G"], jlosses.lsgan_d_loss(jb)["loss_D"]
    np.testing.assert_allclose(float(g_t.detach()), float(g_j), rtol=1e-6)
    np.testing.assert_allclose(float(d_t.detach()), float(d_j), rtol=1e-6)
    np.testing.assert_allclose(float(g_t.detach()), sum(float(np.mean((a - 1) ** 2))
                                               for b in fake for a in b), rtol=1e-6)
    g_t.backward()
    grads_j = jax.grad(lambda lg: jlosses.lsgan_g_loss(
        {"predicted_fake_logits": lg})["loss_G"])(jb["predicted_fake_logits"])
    for bt, bj in zip(tb["predicted_fake_logits"], grads_j):
        for a, w in zip(bt, bj):
            assert _rel(a.grad.numpy(), w) <= 1e-6


@pytest.mark.parametrize("sr", [48000, 24000])
def test_content_criteria_match_jax(sr):
    """At 48 kHz (the log-mel from 4 kHz up) and 24 kHz, on a noisy pair:
    the waveform L1 within 1e-6, the log terms within 1e-4."""
    clean = _wav(19, (2, sr // 4))
    pred = clean + _wav(20, clean.shape, 0.05)
    want = jax.jit(jlosses.content_criteria, static_argnums=2)(jnp.asarray(pred),
                                                               jnp.asarray(clean), sr)
    got = tlosses.content_criteria(torch.from_numpy(pred), torch.from_numpy(clean), sr)
    for g, w, tol in zip(got, want, (1e-6, 1e-4, 1e-4)):
        assert abs(float(g) - float(w)) <= tol * abs(float(w))
