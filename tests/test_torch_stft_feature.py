"""The batch-dict STFT front-end and the frame DFTs of use_tpu_torch
against use_tpu's, on the CPU.

``STFTFeature`` forward and inverse with each compression, freq_high,
use_mag_phase, split_subbands and the speech mask; ``frames_rfft`` /
``frames_irfft`` (torch.fft on frames, the CSMGAN stream's analysis and
synthesis) against use_tpu's DFT matrices (``_dft_matrices``, float64 here)
at n_fft 96 and at CSMGAN's 960, which is not a power of two; and the
window-square envelope. Tolerances (fp32; an FFT against a matmul): spectra
within 1e-5 of their largest |value| plus rtol 1e-4; the phase as
|X| e^{i phase}, so within the same bound: the angle of a bin near 0 is
its rounding's (a bin of 1e-5 turns by a radian between the two), and
atan2 jumps by 2 pi across the negative real axis; the inverse's wav
within 1e-5 of its largest.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import assert_close
from use_tpu.ops.stft import _dft_matrices, _window_sq
from use_tpu.ops.stft_feature import STFTFeature as JFeature
from use_tpu_torch.ops.stft import STFTConfig, frames_irfft, frames_rfft, window_sq
from use_tpu_torch.ops.stft_feature import STFTFeature as TFeature

SR = 16000
CASES = {
    "plain": dict(),
    "sqrt": dict(compression="sqrt"),
    "cubic": dict(compression="cubic", freq_high=4000.0),
    "log_1x": dict(compression="log_1x"),
    "mag_phase": dict(use_mag_phase=True, compression="sqrt"),
    "subbands": dict(split_subbands=4),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def _batch(seed=0, length=2000):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    clean[1, 400:900] = 0.0  # a silent stretch: exact-zero bins
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    return {"clean": clean, "perturbed": noisy,
            "sample_length": np.array([length, length - 333], np.int32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stft_feature_forward_and_inverse_match_jax(case):
    kw = dict(n_fft=128, win_length=128, hop_length=32, sampling_rate=SR, **CASES[case])
    jf, tf = JFeature(**kw), TFeature(**kw)
    b = _batch()
    want = jf({k: jnp.asarray(v) for k, v in b.items()})
    got = tf({k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("_phase"):  # as |X| e^{i phase}: see the docstring
            mag = want[k[: -len("phase")] + "mag"]
            _close(torch.stack([got[k].cos(), got[k].sin()]) * torch.from_numpy(np.array(mag)),
                   np.stack([np.cos(w), np.sin(w)]) * mag)
        elif k == "spectra_length":
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        elif k != "sample_length":
            _close(got[k], w)
    # the inverse of a fake made of the perturbed features
    jb, tb = dict(want), dict(got)
    for src in ("spectra", "mag", "phase", "subband_spectra"):
        if f"perturbed_{src}" in want:
            jb[f"fake_{src}"], tb[f"fake_{src}"] = want[f"perturbed_{src}"], got[f"perturbed_{src}"]
    wj, wt = jf.inverse(jb), tf.inverse(tb)
    _close(wt["fake"], wj["fake"])
    if not CASES[case].get("freq_high"):  # an exact round trip of the perturbed wav
        _close(wt["fake"], b["perturbed"])


@pytest.mark.parametrize("n_fft", [96, 960])
def test_frame_dfts_match_dft_matrices(n_fft):
    """frames_rfft == frames @ fwd and frames_irfft == spec @ inv, use_tpu's
    DFT-matrix step (stft.py:55), on random frames and spectra whose DC and
    Nyquist bins have imaginary parts (the matrix ignores them)."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=n_fft // 2)
    fwd, inv = (m.astype(np.float64) for m in _dft_matrices(n_fft, n_fft, "hann"))
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((3, 5, n_fft)).astype(np.float32)
    f = n_fft // 2 + 1
    want = frames.astype(np.float64) @ fwd
    got = frames_rfft(torch.from_numpy(frames), cfg)
    _close(got, np.stack([want[..., :f], want[..., f:]], axis=-1))
    spec = rng.standard_normal((3, 5, f, 2)).astype(np.float32)
    want = np.concatenate([spec[..., 0], spec[..., 1]], axis=-1).astype(np.float64) @ inv
    _close(frames_irfft(torch.from_numpy(spec), cfg), want)
    np.testing.assert_array_equal(window_sq(n_fft, n_fft, "hann"), _window_sq(n_fft, n_fft, "hann"))
    np.testing.assert_array_equal(window_sq(n_fft, n_fft - 6, "hamm"),
                                  _window_sq(n_fft, n_fft - 6, "hamm"))
