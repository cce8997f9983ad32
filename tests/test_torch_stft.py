"""STFT front-end parity: use_tpu_torch.ops.stft (torch.stft/istft) against
use_tpu.ops.stft (DFT matmuls), on the same numpy signals.

Signals are white noise at speech level (std 0.1, the scale of
peak-normalized 0.8 wavs); tolerance atol 1e-5 on spectra and wavs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export a function named stft, so fetch the modules by name
jstft = importlib.import_module("use_tpu.ops.stft")
tstft = importlib.import_module("use_tpu_torch.ops.stft")

ATOL = 1e-5
CASES = [(1022, 160, 24000), (1022, 160, 24000 + 77), (254, 64, 4000), (254, 64, 4000 + 13)]
IDS = ["1022-aligned", "1022-ragged", "254-aligned", "254-ragged"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _signal(length, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((2, length))).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,length", CASES, ids=IDS)
def test_stft_and_istft_match_jax(n_fft, hop, length):
    x = _signal(length)
    jcfg = jstft.STFTConfig(n_fft=n_fft, hop_length=hop)
    tcfg = tstft.STFTConfig(n_fft=n_fft, hop_length=hop)
    want = np.array(jstft.stft(jnp.asarray(x), jcfg))
    got = tstft.stft(torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + length // hop, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)

    back_j = np.asarray(jstft.istft(jnp.asarray(want), jcfg, length=length))
    back_t = tstft.istft(torch.from_numpy(want), tcfg, length=length).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=ATOL)
    np.testing.assert_allclose(back_t, x, atol=ATOL)


def test_spec_fwd_back_and_pad_match_jax():
    rng = np.random.default_rng(2)
    pair = rng.standard_normal((3, 8, 7, 2)).astype(np.float32)
    pair[0, 0, 0] = 0.0  # an exact-zero bin stays zero, no NaN
    fwd_j = np.array(jstft.spec_fwd(jnp.asarray(pair)))
    fwd_t = tstft.spec_fwd(torch.from_numpy(pair)).numpy()
    np.testing.assert_allclose(fwd_t, fwd_j, atol=ATOL, rtol=1e-6)
    assert np.all(fwd_t[0, 0, 0] == 0.0)
    back_t = tstft.spec_back(torch.from_numpy(fwd_j)).numpy()
    np.testing.assert_allclose(back_t, np.asarray(jstft.spec_back(jnp.asarray(fwd_j))),
                               atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(back_t, pair, atol=ATOL, rtol=1e-5)

    padded_t = tstft.pad_spec(torch.from_numpy(pair), multiple=4).numpy()
    np.testing.assert_array_equal(padded_t, np.asarray(jstft.pad_spec(jnp.asarray(pair), 4)))
    assert padded_t.shape == (3, 8, 8, 2)


def test_window_matches_jax():
    for window in ("hann", "sqrthann", "hamm"):
        np.testing.assert_array_equal(tstft.get_window(window, 510),
                                      jstft.get_window(window, 510))


def test_complex_pair_helpers_match_jax():
    """to_complex / from_complex (use_tpu/ops/stft.py:266-273): [..., 2]
    pairs to complex and back, exactly."""
    from use_tpu.ops import from_complex as jfrom, to_complex as jto
    from use_tpu_torch.ops import from_complex, to_complex

    pair = np.random.default_rng(0).standard_normal((2, 5, 3, 2)).astype(np.float32)
    z = to_complex(torch.from_numpy(pair))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jto(jnp.asarray(pair))))
    np.testing.assert_array_equal(from_complex(z).numpy(), np.asarray(jfrom(jto(jnp.asarray(pair)))))
    np.testing.assert_array_equal(from_complex(z).numpy(), pair)
