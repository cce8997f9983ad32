"""The GAN criteria's signal ops of use_tpu_torch against use_tpu's, on the CPU.

The HTK mel filterbank (built in float64 on both sides: equal to 1e-6 of
its largest value), magnitude and mel spectrograms at the multi-mel
discriminator's three configurations (n_fft 1024 / 256 / 512 with centre-
padded windows of 960 / 240 / 480) and the reconstruction criterion's, and
the polyphase resampler from 24 kHz to 8, 12 and 16 kHz at an odd length.
Tolerance: rtol 1e-5 and atol 1e-5 x max|ref| (fp32; use_tpu's DFT is a
matmul, the port's an FFT, so the sums run in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import assert_close
from use_tpu.ops import mel as jmel
from use_tpu.ops.resample import resample as jresample
from use_tpu.ops.stft import STFTConfig as JSTFTConfig, stft as jstft
from use_tpu_torch.ops import mel as tmel
from use_tpu_torch.ops.resample import resample as tresample
from use_tpu_torch.ops.stft import STFTConfig as TSTFTConfig, reflect_pad, stft as tstft

SR = 24000
MMD = [(1024, 960, 240, 128), (256, 240, 60, 64), (512, 480, 120, 80)]  # n_fft, win, hop, mels


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wav(seed, shape=(2, 7001)):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert_close(got, want, rtol=rtol, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n_freqs,n_mels,f_max", [(513, 128, None), (129, 64, None),
                                                  (257, 80, None), (1025, 128, 12000.0)])
def test_mel_filterbank_matches_jax(n_freqs, n_mels, f_max):
    want = jmel.mel_filterbank(n_freqs, n_mels, SR, 0.0, f_max)
    got = tmel.mel_filterbank(n_freqs, n_mels, SR, 0.0, f_max)
    assert got.shape == want.shape == (n_freqs, n_mels) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(want.max()))


@pytest.mark.parametrize("n_fft,win,hop,n_mels", MMD)
def test_spectrogram_and_melspectrogram_match_jax(n_fft, win, hop, n_mels):
    """The MMD configurations: a window shorter than n_fft, centre-padded."""
    x = _wav(n_fft)
    cfg_j = jmel.MelConfig(sample_rate=SR, n_fft=n_fft, win_length=win, hop_length=hop,
                           n_mels=n_mels)
    cfg_t = tmel.MelConfig(sample_rate=SR, n_fft=n_fft, win_length=win, hop_length=hop,
                           n_mels=n_mels)
    _close(tmel.spectrogram(torch.from_numpy(x), cfg_t.stft_cfg).numpy(),
           jmel.spectrogram(jnp.asarray(x), cfg_j.stft_cfg))
    _close(tmel.melspectrogram(torch.from_numpy(x), cfg_t).numpy(),
           jmel.melspectrogram(jnp.asarray(x), cfg_j))


def test_criterion_mel_and_power_spectrogram_match_jax():
    """The reconstruction criterion's mel (n_fft 2048, 600-sample window,
    hop 240, f_max 12 kHz) and a power-2 spectrogram."""
    x = _wav(5, (1, 9000))
    kw = dict(sample_rate=SR, n_fft=2048, win_length=600, hop_length=240, n_mels=128,
              f_max=12000.0)
    _close(tmel.melspectrogram(torch.from_numpy(x), tmel.MelConfig(**kw)).numpy(),
           jmel.melspectrogram(jnp.asarray(x), jmel.MelConfig(**kw)))
    _close(tmel.spectrogram(torch.from_numpy(x), TSTFTConfig(n_fft=512, hop_length=128), 2.0)
           .numpy(), jmel.spectrogram(jnp.asarray(x), JSTFTConfig(n_fft=512, hop_length=128), 2.0))


def test_stft_reflects_again_where_the_pad_outgrows_the_signal():
    """A centre pad longer than the clip (n_fft 2048 on 900 samples) reflects
    again, as jnp.pad's reflect does, where torch's reflect pad raises; so
    do one-sided pads (the period fold's)."""
    x = _wav(6, (2, 900))
    for left, right in ((1024, 1024), (0, 5), (3, 0), (7, 2000)):
        pad = reflect_pad(torch.from_numpy(x), left, right).numpy()
        np.testing.assert_array_equal(pad, np.pad(x, ((0, 0), (left, right)), mode="reflect"))
    cfg = dict(n_fft=2048, hop_length=240, win_length=600)
    _close(tstft(torch.from_numpy(x), TSTFTConfig(**cfg)).numpy(),
           jstft(jnp.asarray(x), JSTFTConfig(**cfg)))


@pytest.mark.parametrize("new_sr", [8000, 12000, 16000])
def test_resample_matches_jax_at_an_odd_length(new_sr):
    """24 kHz -> new_sr at 7001 samples: ceil(7001 new / 24000) outputs."""
    x = _wav(new_sr)
    want = np.asarray(jresample(jnp.asarray(x), SR, new_sr))
    got = tresample(torch.from_numpy(x), SR, new_sr)
    assert got.shape == want.shape == (2, int(np.ceil(7001 * new_sr / SR)))
    _close(got.numpy(), want)
    same = torch.from_numpy(x)
    assert tresample(same, SR, SR) is same
