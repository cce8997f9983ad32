"""The CSMGAN recipe on use_tpu_torch's CLI, on the CPU, at
tests/test_torch_csmgan.py's tiny configuration and tolerances:
`predict experiment=CSMGAN` streaming and offline against use_tpu's
wrapper on the same weights, the streaming configurations refused with
use_tpu's messages, and `train` / `eval experiment=CSMGAN`.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_csmgan import (  # noqa: F401 (fixtures)
    CLI_TINY,
    SR,
    _clip,
    _close,
    _jax_offline,
    _two_torch_threads,
    nets,
)
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.data.synth_speech import synth_pair
from use_tpu_torch.engine.checkpoint import CheckpointManager
from use_tpu_torch.engine.convert_jax import csmgan_params_to_state_dict


FILES = {os.path.join("sub", "a.wav"): 5001, "b.wav": 9001}  # both padded to 16000


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("csmgan_cli")
    for i, (rel, n) in enumerate(FILES.items()):
        write_wav(str(root / "in" / rel), _clip(20 + i, n, silent=True)[0], SR)
    return root


def _predict(root, out, *extra, experiment="CSMGAN"):
    return main(["predict", f"experiment={experiment}", "device=cpu", *CLI_TINY,
                 f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}",
                 *extra])


def test_cli_predict_streaming_and_offline_match_jax(wav_tree, nets):
    """`predict experiment=CSMGAN` with predict.streaming=true
    predict.chunk_frames=2 (one session over both files), and offline, from
    a .pt of use_tpu's weights: the wavs (mirrored, length-matched) equal
    use_tpu's CSMGANWrapper on the same weights, on the clip as the loader
    hands it over (peak 0.8, padded to a multiple of 16000). use_tpu's own
    CLI initializes its 24k_MVD bank eagerly, which takes it most of a
    minute on the CPU; its streaming equals its offline pass in its own tests."""
    jw, params, _ = nets
    small = jax.tree.map(lambda a: 0.5 * a, params)  # keeps the wavs inside [-1, 1]
    torch.save(csmgan_params_to_state_dict(small), wav_tree / "g.pt")
    want = {}
    for rel, n in FILES.items():
        wav, _ = read_wav(str(wav_tree / "in" / rel))
        wav = np.pad((wav / np.abs(wav).max() * 0.8).astype(np.float32), (0, -n % 16000))
        want[rel] = np.asarray(_jax_offline(jw, small, wav[None]))[0, :n]
        assert np.abs(want[rel]).max() < 1.0  # not clipped by the writer
    for label, extra in {"stream": ("predict.streaming=true", "predict.chunk_frames=2"),
                         "offline": ()}.items():
        summary = _predict(wav_tree, label, f"ckpt_path={wav_tree / 'g.pt'}", *extra)
        assert summary["files"] == len(FILES)
        for rel, n in FILES.items():
            got, sr = read_wav(str(wav_tree / label / rel))
            assert sr == SR and got.shape == (n,)
            _close(got, want[rel])


@pytest.mark.parametrize("extra, message", [
    (("predict.chunk_frames=1",), "predict.chunk_frames=1 invalid"),
    (("model.generator.hop_length=40",), "win_length == n_fft == 2\\*hop"),
    (("predict.chain=gan+sgmse", "predict.second_experiment=SGMSE_debug"),
     "requires task=lsgan with a streamable generator"),
])
def test_cli_refuses_streaming_as_use_tpu_does(wav_tree, extra, message):
    with pytest.raises(SystemExit, match=message):
        _predict(wav_tree, "refused", "predict.streaming=true", *extra)


def test_cli_train_and_eval_from_checkpoint(tmp_path):
    """`train experiment=CSMGAN device=cpu` for one step on two synth_speech
    clips of 0.5 s (batch 2, accumulation 1), the checkpoint holding G and
    D, and `eval` of it (chip_smoke.py streams from such a checkpoint)."""
    jl = tmp_path / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(2):
            clean, _ = synth_pair(SR // 2, i, snr_db=5.0, sr=SR)
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 0.5, "sample_rate": SR}) + "\n")
    data = [f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
            "data.reverb_use_FRA=true", "data.min_duration_seconds=0.1",
            "data.speech_splice_seconds=0.5", "data.num_workers=0", "data.batch_size=2",
            "train.accumulate_grad_batches=1"]
    out = tmp_path / "run"
    summary = main(["train", "experiment=CSMGAN", *CLI_TINY, *data, "train.max_epochs=1",
                    f"out_dir={out}", "device=cpu"])
    assert summary["optimizer_steps"] == 1 and summary["clips"] == 2
    row = summary["history"][0]
    assert np.isfinite(row["train/loss_G"]) and np.isfinite(row["train/loss_D"])
    state = CheckpointManager(str(out / "checkpoints")).restore(0)
    assert set(state) == {"g", "d"} and state["g"]["step"] == state["d"]["step"] == 1
    assert "bottleneck.TCN.0.dconv1d.weight" in state["g"]["model"]
    ev = main(["eval", "experiment=CSMGAN", *CLI_TINY, *data, f"ckpt_path={out}/checkpoints",
               "eval.max_files=1", f"out_dir={tmp_path / 'eval'}", "device=cpu"])
    assert ev["test"] and all(np.isfinite(v) for v in ev["test"].values())
    assert ev["files"] == 1 and all(np.isfinite(v) for v in ev["rich"].values())
