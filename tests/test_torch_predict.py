"""The port's predict CLI on the CPU: folder -> folder enhancement with
`experiment=SGMSE_debug device=cpu infer.N=2` writes mirrored, length-matched,
finite wavs, and `ckpt_path=` loads a torch state_dict of the backbone."""
import os

import numpy as np
import pytest
import torch

from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav

SR = 24000
FILES = {"a.wav": 9000, os.path.join("sub", "dir", "b.wav"): 6100}


@pytest.fixture
def wav_tree(tmp_path):
    rng = np.random.default_rng(0)
    for rel, n in FILES.items():
        write_wav(str(tmp_path / "in" / rel), (0.1 * rng.standard_normal(n)).astype(np.float32), SR)
    return tmp_path


def _predict(root, out, *extra):
    return main(["predict", "experiment=SGMSE_debug", "device=cpu", "infer.N=2",
                 f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}",
                 *extra])


def _read(root, out):
    return {rel: read_wav(str(root / out / rel)) for rel in FILES}


def test_predict_writes_mirrored_finite_wavs(wav_tree):
    summary = _predict(wav_tree, "out")
    assert summary["files"] == len(FILES)
    assert summary["audio_seconds"] == pytest.approx(sum(FILES.values()) / SR)
    for rel, (data, sr) in _read(wav_tree, "out").items():
        assert sr == SR and data.shape == (FILES[rel],) and np.isfinite(data).all()


def test_predict_loads_state_dict_checkpoint(wav_tree):
    import use_tpu_torch.models  # noqa: F401
    from use_tpu_torch.models import BackboneRegistry

    net = BackboneRegistry.get_by_name("ncsnpp6M")(input_channels=4, seed=7)
    ckpt = wav_tree / "weights.pt"
    torch.save(net.state_dict(), ckpt)
    _predict(wav_tree, "out_seed", "infer.N=1")
    _predict(wav_tree, "out_ckpt", "infer.N=1", f"ckpt_path={ckpt}")
    seed_out, ckpt_out = _read(wav_tree, "out_seed"), _read(wav_tree, "out_ckpt")
    for rel in FILES:
        assert np.isfinite(ckpt_out[rel][0]).all()
        assert not np.allclose(ckpt_out[rel][0], seed_out[rel][0])  # other weights

    bad = wav_tree / "bad.pt"
    torch.save({"not_a_param": torch.zeros(1)}, bad)
    with pytest.raises(RuntimeError):
        _predict(wav_tree, "out_bad", f"ckpt_path={bad}")


def test_predict_int8_serving_quantizes_bf16_weights(wav_tree, monkeypatch):
    """`model.backbone_kwargs.*` reach the backbone: the int8 serving path
    runs its fused convs on bf16 activations, with the weights cast to bf16
    before they are quantized (as use_tpu's cast_params_for_inference)."""
    from use_tpu_torch.ops import fused_qconv

    seen = []
    real = fused_qconv.qconv3x3_fused

    def record(x, weight, u, *args, **kw):
        seen.append((x.dtype, weight.dtype, kw["out_dtype"]))
        return real(x, weight, u, *args, **kw)

    monkeypatch.setattr(fused_qconv, "qconv3x3_fused", record)
    summary = _predict(wav_tree, "out_int8", "infer.N=1", "model.backbone_kwargs.quant=int8_pallas",
                       "model.backbone_kwargs.dtype=bfloat16",
                       "model.backbone_kwargs.quant_min_channels=96")
    assert summary["files"] == len(FILES)
    for rel, (data, sr) in _read(wav_tree, "out_int8").items():
        assert sr == SR and data.shape == (FILES[rel],) and np.isfinite(data).all()
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("argv", [
    ["eval", "experiment=SGMSE_debug", "eval.unknown=1"],
    ["predict", "experiment=SGMSE_debug", "predict.streaming=true"],
    ["predict", "experiment=SGMSE_debug", "predict.unknown=1"],
    ["predict", "experiment=LSGAN_debug", "predict.chunk_frames=4"],
    ["train", "experiment=LSGAN_debug", "device=cpu", "predict.streaming=true"],
])
def test_unported_commands_and_keys_exit(argv):
    with pytest.raises(SystemExit):
        main(argv)
