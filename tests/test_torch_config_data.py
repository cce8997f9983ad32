"""The port's config, registry and predict-data modules against use_tpu's:
the same experiments resolve to the same dicts, the YAMLs are unchanged
copies, and the predict batches pad and resample as use_tpu's do."""
import os

import numpy as np
import pytest
import torch

from use_tpu.config import config as jconfig
from use_tpu.data import collate as jcollate
from use_tpu.data import dsp as jdsp
from use_tpu_torch.config import config as tconfig
from use_tpu_torch.data import loadwav as tload
from use_tpu_torch.data.audio_io import write_wav
from use_tpu_torch.utils.registry import Registry


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["SGMSE_Large", "SGMSE_debug"])
def test_experiments_are_copies_and_resolve_alike(name):
    with open(os.path.join(jconfig.EXPERIMENTS_DIR, f"{name}.yaml"), "rb") as f:
        want = f.read()
    with open(os.path.join(tconfig.EXPERIMENTS_DIR, f"{name}.yaml"), "rb") as f:
        assert f.read() == want
    overrides = ["infer.N=7", "train.lr=1e-5", "model.backbone_kwargs.dtype=bfloat16"]
    got = tconfig.load_config(name, overrides)
    assert got == jconfig.load_config(name, overrides)
    assert got["infer"]["N"] == 7 and got["train"]["lr"] == 1e-5


def test_registry_warns_on_double_registration():
    reg = Registry("Thing")
    reg.register("a")(1)
    with pytest.warns(UserWarning, match="doubly registered"):
        reg.register("a")(2)
    assert reg.get_by_name("a") == 2 and "a" in reg and reg.get_all_names() == ["a"]
    with pytest.raises(ValueError, match="Available"):
        reg.get_by_name("b")


def test_predict_batches_pad_and_resample_like_use_tpu(tmp_path):
    rng = np.random.default_rng(0)
    write_wav(str(tmp_path / "in" / "x" / "a.wav"), (0.3 * rng.standard_normal(5000)).astype(np.float32), 16000)
    write_wav(str(tmp_path / "in" / "b.wav"), (0.3 * rng.standard_normal(7000)).astype(np.float32), 24000)
    ds = tload.LoadWavDataset(tload.LoadWavConfig(data_folder=str(tmp_path / "in"),
                                                  target_folder=str(tmp_path / "out")))
    items = [ds[i] for i in range(len(ds))]
    assert [os.path.basename(i["audio_path"]) for i in items] == ["b.wav", "a.wav"]
    for item in items:
        assert np.abs(item["perturbed"]).max() == pytest.approx(0.8)
    assert len(items[1]["perturbed"]) == 7500  # 5000 samples at 16 kHz -> 24 kHz

    x = rng.standard_normal(1234)
    np.testing.assert_array_equal(tload.resample_fft(x, 16000, 24000),
                                  jdsp.resample_fft(x, 16000, 24000))
    got = tload.pad_to_longest_monaural_inference(items)
    want = jcollate.pad_to_longest_monaural_inference(items)
    np.testing.assert_array_equal(got["perturbed"], want["perturbed"])
    np.testing.assert_array_equal(got["sample_length"], want["sample_length"])
    assert got["perturbed"].shape == (2, 16000)
    assert got["audio_path"] == want["audio_path"]
    assert [b["sample_length"].tolist() for b in tload.predict_batches(ds)] == [[7000], [7500]]
