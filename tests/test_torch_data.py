"""Data pipeline parity: use_tpu_torch.data against use_tpu.data, bit for bit.

The port's data modules are its own copies; under the same `random` and
`np.random` seeds they must give use_tpu's arrays exactly: every
perturbation class, `vad_merge`, `DistortDataset` items, `fra_rir`,
`synth_speech`, the batch order and collation of the loaders (in-process,
and with one spawned worker, whose seeding both packages share).
"""
import json
import os
import random

import numpy as np
import pytest
import torch

from use_tpu.data import collate as jcollate
from use_tpu.data import datamodule as jdm
from use_tpu.data import distort_dataset as jdd
from use_tpu.data import dsp as jdsp
from use_tpu.data import fra_rir as jfra
from use_tpu.data import perturb as jP
from use_tpu.data import synth_speech as jsynth
from use_tpu_torch.data import collate as tcollate
from use_tpu_torch.data import datamodule as tdm
from use_tpu_torch.data import distort_dataset as tdd
from use_tpu_torch.data import dsp as tdsp
from use_tpu_torch.data import fra_rir as tfra
from use_tpu_torch.data import perturb as tP
from use_tpu_torch.data import synth_speech as tsynth
from use_tpu_torch.data.audio_io import write_wav

SR = 24000
PERTURBS = sorted(n for n, c in vars(jP).items()
                  if isinstance(c, type) and c.__module__ == jP.__name__)
KWARGS = {"WhiteNoisePerturb": {"snr_min": 5, "snr_max": 20},
          "LowPassPerturb": {"max_cutoff_freq": 11000},  # below the 12 kHz Nyquist
          "_CodecSimulacrum": {"bandwidth_hz": 3400, "bits_min": 4, "bits_max": 8,
                               "delay_samples": 10}}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def test_every_perturbation_class_is_ported():
    assert len(PERTURBS) == 33
    assert PERTURBS == sorted(n for n, c in vars(tP).items()
                              if isinstance(c, type) and c.__module__ == tP.__name__)


@pytest.mark.parametrize("name", PERTURBS)
def test_perturbation_bit_equal(name):
    """Each class, built and applied under the same seeds (both draw from
    the global `random` / `np.random`; WebRTC NS's level included), gives
    use_tpu's output exactly, for two seeds."""
    clean, _ = jsynth.synth_pair(SR // 2, 0, snr_db=10.0, sr=SR)
    data = (0.5 * clean).astype(np.float32)
    for seed in (0, 1):
        want = _seeded(seed, lambda: getattr(jP, name)(SR, **KWARGS.get(name, {}))(data.copy()))
        got = _seeded(seed, lambda: getattr(tP, name)(SR, **KWARGS.get(name, {}))(data.copy()))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_dsp_fra_rir_synth_and_vad_bit_equal():
    x = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(tdsp.np_stft(x, 512, 128), jdsp.np_stft(x, 512, 128))
    spec = jdsp.np_stft(x, 512, 128)
    np.testing.assert_array_equal(tdsp.np_istft(spec, 128, 5000), jdsp.np_istft(spec, 128, 5000))
    for fn in ("resample_fft", "resample_poly"):
        np.testing.assert_array_equal(getattr(tdsp, fn)(x, 16000, 24000),
                                      getattr(jdsp, fn)(x, 16000, 24000))
    np.testing.assert_array_equal(tdsp.compressor_envelope_np(x[:300], 0.9, 0.99),
                                  jdsp.compressor_envelope_np(x[:300], 0.9, 0.99))
    for a, b in zip(_seeded(3, lambda: tfra.fra_rir(sr=SR)), _seeded(3, lambda: jfra.fra_rir(sr=SR))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsynth.synth_pair(4000, 7, snr_db=5.0, sr=SR),
                    jsynth.synth_pair(4000, 7, snr_db=5.0, sr=SR)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdd.vad_merge(x), jdd.vad_merge(x))


@pytest.fixture
def corpus(tmp_path):
    """Four synth_speech clips of 1 s and their jsonl list."""
    jl = tmp_path / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(4):
            clean, _ = jsynth.synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    return str(jl)


def _cfg(mod, jl, **kw):
    return mod.DistortConfig(clean_json_path=jl, noise_json_path=jl, reverb_use_FRA=True,
                             min_duration_seconds=0.1, speech_splice_seconds=1, **kw)


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v or (v != v and got[k] != got[k]), k  # NaN == NaN


@pytest.mark.parametrize("seed", [0, 5])
def test_distort_dataset_items_bit_equal(corpus, seed):
    """DistortDataset.__getitem__ at several indices under the same seeds;
    with the WebRTC NS and packet-loss-on-VAD paths switched on too."""
    for kw in ({}, {"webrtc_ns_prob": 1.0, "packet_loss_on_vad": True}):
        jds, tds = jdd.DistortDataset(_cfg(jdd, corpus, **kw)), tdd.DistortDataset(_cfg(tdd, corpus, **kw))
        assert len(jds) == len(tds)
        for idx in (0, 2, 3):
            _assert_items_equal(_seeded(seed + idx, lambda: tds[idx]),
                                _seeded(seed + idx, lambda: jds[idx]))


def _epochs(dm, n_epochs, seed):
    out = []
    for e in range(n_epochs):
        random.seed(seed + e)
        np.random.seed(seed + e)
        out.append([b for b in dm.train_dataloader()] + [b for b in dm.val_dataloader()])
    return out


@pytest.mark.parametrize("overfit", [None, 3])
def test_datamodule_batches_bit_equal(corpus, overfit):
    """Two epochs of train + val batches in-process: use_tpu's batch order
    (shuffle by default_rng(seed + epoch), drop_last) and collation, and
    _FixedSubset's replay under overfit_items."""
    kw = dict(batch_size=2, num_workers=0, seed=11, overfit_items=overfit)
    want = _epochs(jdm.DistortDataModule(train_cfg=_cfg(jdd, corpus), **kw), 2, 4)
    got = _epochs(tdm.DistortDataModule(train_cfg=_cfg(tdd, corpus), **kw), 2, 4)
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            _assert_items_equal(g, w)
    loader = tdm.DistortDataModule(train_cfg=_cfg(tdd, corpus), **kw).train_dataloader()
    assert len(loader) == (1 if overfit else 2)


def test_spawned_worker_seeding_matches_jax(corpus):
    """One worker: both packages hand it every item of the epoch in order
    and seed it with seed + 1000 epoch (np.random) and one more (random),
    so its batches are use_tpu's, bit for bit."""
    kw = dict(batch_size=2, shuffle=True, num_workers=1, seed=3, drop_last=True)
    from use_tpu.data.loader import DataLoader as JLoader
    from use_tpu_torch.data.loader import DataLoader as TLoader

    want = list(JLoader(jdd.DistortDataset(_cfg(jdd, corpus)),
                        collate_fn=jcollate.pad_to_longest_monaural, **kw))
    got = list(TLoader(tdd.DistortDataset(_cfg(tdd, corpus)),
                       collate_fn=tcollate.pad_to_longest_monaural, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def test_native_library_builds_outside_native_dir():
    """The port's loader of native/dsp.cpp builds into use_tpu_torch/_build,
    and its fast path equals the numpy fallback."""
    from use_tpu_torch.data import native

    lib = native._load()
    if lib is not None:
        assert os.path.dirname(native._LIB_PATH).endswith(os.path.join("use_tpu_torch", "_build"))
    level = np.random.default_rng(2).standard_normal(400).astype(np.float32)
    np.testing.assert_allclose(native.envelope_follow(level, 0.9, 0.99),
                               tdsp.compressor_envelope_np(level, 0.9, 0.99), rtol=1e-5, atol=1e-5)
