"""The GAN zoo's discriminators in use_tpu_torch against use_tpu's, on the
CPU: the db3 DWT, the multi-scale and spectrogram discriminators and the
24k bank (MPD, MSD, MMD); tests/test_torch_gan_zoo_generators.py holds the
generators and the criteria.

Inputs and weights are drawn with numpy from a seed; weights move with
engine/convert_jax.py (each load strict, so the converters cover every
parameter). use_tpu's NWC / NHWC maps are transposed to NCW / NCHW.
Tolerances (fp32; the frameworks sum convolutions in other orders): each
tensor within 1e-5 of its own largest |value|; the mel bank's within 1e-4,
as tests/test_torch_discriminators.py argues: its log-mel input comes
through use_tpu's matmul DFT on one side and an FFT on the other. The
spectrogram discriminators' inputs are STFT magnitudes, floored at
sqrt(1e-7), where a near-null bin reads the DFTs' rounding: they are held
to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.models.gan import msd as jmsd, spec_discriminator as jspec
from use_tpu.models.gan.discriminators import HifiganVocoderDiscriminator24k as J24k
from use_tpu_torch.engine.convert_jax import discriminator_params_to_state_dict
from use_tpu_torch.models.gan import msd as tmsd, spec_discriminator as tspec
from use_tpu_torch.models.registry import DiscriminatorRegistry

LENGTH = 4001  # the 24k bank's clip: 0.17 s, not a multiple of any period
BANKS = {"MPD": [2, 3, 5, 7, 11], "MSD": [0, 1, 2], "MMD": [0, 1, 2]}
CASES = [(b, i) for b, names in enumerate(BANKS.values()) for i in range(len(names))]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_ncw(a):
    return np.moveaxis(np.asarray(a), -1, 1)  # NHWC / NWC -> NCHW / NCW


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _wav(seed, shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _jax(module, x, seed, *args, **kw):
    """use_tpu's module on random params: -> (params, its jitted output)."""
    params = random_params(jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, *args),
                                          x)["params"], seed=seed)
    return params, jax.jit(lambda p, x: module.apply({"params": p}, x, *args, **kw))(params, x)


def _check_bank(lt, ft, lj, fj, tol):
    assert len(lt) == len(lj) and len(ft) == len(fj)
    for g, w, fg, fw in zip(lt, lj, ft, fj):
        assert _rel(g.numpy(), w) <= tol
        assert len(fg) == len(fw)
        for a, b in zip(fg, fw):
            assert _rel(a.numpy(), _to_ncw(b)) <= tol


@pytest.mark.parametrize("length", [1001, 1000])
def test_dwt1d_db3_matches_jax(length):
    """Odd and even T: the lengths (T + 2) // 2 + 1 and both bands, against
    use_tpu's strided correlation with the reversed filters."""
    x = _wav(0, (2, length, 1))
    lo_j, hi_j = jmsd.dwt1d_db3(jnp.asarray(x))
    lo_t, hi_t = tmsd.dwt1d_db3(torch.from_numpy(_to_ncw(x)).contiguous())
    assert lo_t.shape == (2, 1, (length + 2) // 2 + 1)
    assert _rel(lo_t.numpy(), _to_ncw(lo_j)) <= 1e-6 and _rel(hi_t.numpy(), _to_ncw(hi_j)) <= 1e-6


def test_scale_discriminator_matches_jax():
    """One scale at narrower widths (16 channels up to 64, groups 4 and 16
    kept), on an odd length."""
    kw = dict(channels=16, max_downsample_channels=64)
    x = _wav(1, (2, 1999, 1))
    params, (lj, fj) = _jax(jmsd.ScaleDiscriminator(**kw), jnp.asarray(x), 2)
    td = tmsd.ScaleDiscriminator(**kw)
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        lt, ft = td(torch.from_numpy(_to_ncw(x)).contiguous())
    _check_bank([lt], [ft], [lj], [fj], 1e-5)


def test_multi_scale_discriminator_matches_jax():
    x = _wav(3, (2, 3001))
    params, (lj, fj) = _jax(jmsd.MultiScaleDiscriminator(), jnp.asarray(x), 4)
    td = tmsd.MultiScaleDiscriminator()
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    assert {k.split(".")[0] for k in td.state_dict()} == {
        "scale0", "scale1", "scale2", "aux_conv0", "aux_conv1"}
    with torch.no_grad():
        lt, ft = td(torch.from_numpy(x))
    _check_bank(lt, ft, lj, fj, 1e-5)


@pytest.fixture(scope="module")
def bank24k():
    """use_tpu's and the port's 24k bank, default widths, one set of random
    params, one clip; -> (params, (jax logits, maps), (port logits, maps))."""
    x = _wav(0, (2, LENGTH))
    params, want = _jax(J24k(), jnp.asarray(x), 1)
    td = DiscriminatorRegistry.get_by_name("hifigan_vocoder_discriminator_24k")(seed=0)
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    return params, td, want, got


@pytest.mark.parametrize("bank,disc", CASES, ids=[f"{b}-{n}" for b, names in BANKS.items()
                                                  for n in names])
def test_24k_bank_matches_jax(bank24k, bank, disc):
    _, _, (lj, fj), (lt, ft) = bank24k
    tol = 1e-4 if bank == 2 else 1e-5
    _check_bank([lt[bank][disc]], [ft[bank][disc]], [lj[bank][disc]], [fj[bank][disc]], tol)


def test_24k_bank_structure(bank24k):
    """[bank][disc]: five period, three scale, three mel discriminators, the
    scale discriminators' eight maps each; every parameter of use_tpu's
    bank loads (the converter covers MSD's scopes)."""
    params, td, _, (lt, ft) = bank24k
    assert [len(b) for b in lt] == [5, 3, 3]
    assert all(len(fm) == 8 for fm in ft[1])
    assert len(jax.tree_util.tree_leaves(params)) == len(td.state_dict())


def test_spec_discriminator_matches_jax():
    """conv_in of kernel 15 and 32 channels (the class defaults), a window
    shorter than n_fft, and the width axis that Flax's padding grows."""
    x = _wav(5, (2, 2400))
    kw = dict(fft_size=256, shift_size=64, win_length=200)
    params, (lj, fj) = _jax(jspec.SpecDiscriminator(**kw), jnp.asarray(x), 6)
    td = tspec.SpecDiscriminator(**kw)
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        lt, ft = td(torch.from_numpy(x))
    assert lt.shape[-1] == 1 + 2 * 7 + 3 * 2 * 5 + 2 * 2  # the width axis of 1, padded
    _check_bank([lt], [ft], [lj], [fj], 1e-4)


def test_multi_spec_discriminator_matches_jax():
    x = _wav(7, (2, 4800))
    params, (lj, fj) = _jax(jspec.MultiSpecDiscriminator(), jnp.asarray(x), 8)
    td = tspec.MultiSpecDiscriminator()
    td.load_state_dict(discriminator_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        lt, ft = td(torch.from_numpy(x))
    _check_bank(lt, ft, lj, fj, 1e-4)


def test_spec_discriminator_takes_no_gradient_through_the_stft():
    td = tspec.SpecDiscriminator(fft_size=256, shift_size=64, win_length=200)
    x = torch.from_numpy(_wav(9, (1, 2400))).requires_grad_(True)
    lt, _ = td(x)
    lt.sum().backward()
    assert x.grad is None and td.conv_in.weight.grad is not None
