"""The CLI's GAN task with the zoo's names, on the CPU: `train
experiment=LSGAN_debug model.discriminator=hifigan_vocoder_discriminator_24k
device=cpu` and `eval` of its checkpoint with the same bank, and the
refusal of the zoo's bare generators (hifigan_generator, hifigan_bwe) for
task=lsgan before a model is built, as use_tpu refuses them.
"""
import json
import os

import numpy as np
import pytest
import torch

import use_tpu_torch.models  # noqa: F401 (registries)
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import write_wav
from use_tpu_torch.data.synth_speech import synth_pair
from use_tpu_torch.engine.checkpoint import CheckpointManager

SR = 24000
BANK = "hifigan_vocoder_discriminator_24k"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_trains_lsgan_with_the_24k_bank(tmp_path):
    """`train experiment=LSGAN_debug model.discriminator=...24k`: one
    optimizer step of G and D, finite losses, a checkpoint whose D holds
    the multi-scale bank; `eval` of it with the same bank."""
    jl = tmp_path / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(2):
            clean, _ = synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    data = [f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
            "data.reverb_use_FRA=true", "data.min_duration_seconds=0.1",
            "data.speech_splice_seconds=1", "data.num_workers=0", f"model.discriminator={BANK}"]
    out = str(tmp_path / "run")
    summary = main(["train", "experiment=LSGAN_debug", *data, "train.max_epochs=1",
                    f"out_dir={out}", "device=cpu"])
    assert summary["optimizer_steps"] == 1
    row = summary["history"][0]
    assert np.isfinite(row["train/loss_G"]) and np.isfinite(row["train/loss_D"])
    state = CheckpointManager(os.path.join(out, "checkpoints")).restore(0)
    assert set(state) == {"g", "d"}
    assert any(k.startswith("MSD.scale2.") for k in state["d"]["model"])
    ev = main(["eval", "experiment=LSGAN_debug", *data, f"ckpt_path={out}/checkpoints",
               "eval.rich=false", f"out_dir={tmp_path / 'eval'}", "device=cpu"])
    assert ev["test"] and all(np.isfinite(v) for v in ev["test"].values())


@pytest.mark.parametrize("name,cls", [("hifigan_generator", "HifiganGenerator"),
                                      ("hifigan_bwe", "BandwidthExtender")])
def test_cli_refuses_the_bare_generators_before_building(tmp_path, monkeypatch, name, cls):
    """use_tpu's refusal (cli/main.py:82-100), raised from the registered
    class before one is built."""
    from use_tpu_torch.models.registry import GeneratorRegistry

    built = []
    gen_cls = GeneratorRegistry.get_by_name(name)
    assert gen_cls.__name__ == cls
    monkeypatch.setattr(gen_cls, "__init__", lambda self, *a, **kw: built.append(a))
    (tmp_path / "in").mkdir()
    with pytest.raises(SystemExit, match=f"{name} resolves {cls}, which lacks the LSGAN "
                                         "generator interface"):
        main(["predict", "experiment=LSGAN_debug", f"model.generator.name={name}",
              f"predict.data_folder={tmp_path / 'in'}",
              f"predict.target_folder={tmp_path / 'out'}", "device=cpu"])
    assert not built
