"""The LSGAN generator and task of use_tpu_torch against use_tpu's, serving.

The generator is NCSN++ in discriminative mode behind the STFT front-end;
both sides get the same weights (use_tpu's Flax params, converted by
engine/convert_jax.py::lsgan_params_to_state_dict) and the same wavs.
Tolerance: rtol 1e-4 and atol 1e-5 x max|ref| on the wav, as the NCSN++
parity tests (the frameworks sum convolutions in other orders); the CLI
tests check mirrored, length-matched, finite wavs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.engine.convert_torch import convert_ncsnpp_state_dict
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.engine.convert_jax import lsgan_params_to_state_dict
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN

# the LSGAN_debug generator (ncsnpp6M, n_fft 254, hop 64) with nf cut to 16
GEN = dict(backbone="ncsnpp6M", n_fft=254, hop_length=64, num_frames=32,
           backbone_kwargs=dict(nf=16))
SR = 24000
FILES = {os.path.join("sub", "dir", "b.wav"): 6101}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _generators(seed=3):
    jg = JGenerator(**GEN)
    params = random_params(jax.eval_shape(jg.init_params, jax.random.PRNGKey(0)), seed=seed)
    tg = TGenerator(**GEN, device="cpu")
    tg.net.load_state_dict(lsgan_params_to_state_dict(params), strict=True)
    return jg, params, tg


def test_generator_is_discriminative_ncsnpp():
    tg = TGenerator(**GEN, device="cpu")
    cfg = tg.net.cfg
    assert (cfg.input_channels, cfg.conditional, cfg.scale_by_sigma) == (2, False, False)
    assert tg.target_len == 31 * 64


def test_generator_forward_infer_matches_jax():
    """Batch 2 at an odd length (2001 samples: 32 frames, padded to 64 and
    cut back to 2001 after the iSTFT)."""
    jg, params, tg = _generators()
    wav = (0.1 * np.random.default_rng(0).standard_normal((2, 2001))).astype(np.float32)
    want = jg.forward_infer(params, {"perturbed": jnp.asarray(wav)})["fake"]
    got = tg.forward_infer({"perturbed": torch.from_numpy(wav)})["fake"]
    assert got.shape == want.shape == (2, 2001)
    _close(got.numpy(), want)


def test_lsgan_enhance_matches_jax():
    jg, params, tg = _generators(seed=4)
    wav = (0.1 * np.random.default_rng(1).standard_normal((1, 3333))).astype(np.float32)
    want = JLSGAN(generator=jg).enhance(params, {"perturbed": jnp.asarray(wav)})["fake"]
    out = TLSGAN(generator=tg).enhance({"perturbed": torch.from_numpy(wav)})
    assert set(out) == {"perturbed", "fake"}
    _close(out["fake"].numpy(), want)


def test_lsgan_params_round_trip_through_use_tpu_convert_torch():
    """use_tpu params -> the port's state_dict -> use_tpu's convert_torch ->
    the same params, array for array (neither side holds a time embedding),
    and the port's state_dict loads strictly into the generator's net."""
    _, params, tg = _generators(seed=5)
    state = lsgan_params_to_state_dict(params)
    assert set(state) == set(tg.net.state_dict())
    back = convert_ncsnpp_state_dict(state)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == set(flat_back)
    for path, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(arr))


def test_generator_training_path_is_not_ported():
    """The training path, which raised "not ported yet" until LSGAN
    training came (tests/test_torch_gan_train.py holds it against
    use_tpu's): train=True with a clean clip crops both clips to
    target_len and writes the fake; without a clean clip it serves."""
    tg = TGenerator(**GEN, device="cpu")
    batch = {"clean": torch.zeros((1, 2000)), "perturbed": torch.zeros((1, 2000))}
    out = tg(batch, torch.Generator().manual_seed(0), train=True)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "clean": (1, tg.target_len), "perturbed": (1, tg.target_len), "fake": (1, tg.target_len)}
    assert tg({"perturbed": torch.zeros((1, 2000))}, train=True)["fake"].shape == (1, 2000)


def test_generator_serving_cast_gives_the_shortcut_bf16_weights():
    """backbone_kwargs.dtype=bfloat16: LSGAN.cast_params_for_inference casts
    the generator's backbone once, as ScoreModel's (K2's weight and bias
    bf16, GroupNorm affines fp32)."""
    from use_tpu_torch.models.ncsnpp.layers import ResnetBlockBigGANpp

    tg = TGenerator(**{**GEN, "backbone_kwargs": dict(nf=16, dtype="bfloat16")}, device="cpu")
    TLSGAN(generator=tg).cast_params_for_inference()
    shortcuts = [m.Conv_2 for m in tg.net.modules()
                 if isinstance(m, ResnetBlockBigGANpp) and m.Conv_2 is not None]
    assert shortcuts
    for conv in shortcuts:
        assert conv.weight.dtype == conv.bias.dtype == torch.bfloat16
    for name, p in tg.net.named_parameters():
        if "GroupNorm" in name:
            assert p.dtype == torch.float32, name
    out = tg.forward_infer({"perturbed": torch.zeros((1, 2001))})["fake"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.fixture
def wav_tree(tmp_path):
    rng = np.random.default_rng(0)
    for rel, n in FILES.items():
        write_wav(str(tmp_path / "in" / rel), (0.1 * rng.standard_normal(n)).astype(np.float32), SR)
    return tmp_path


def _predict(root, out, *extra):
    return main(["predict", "experiment=LSGAN_debug", "device=cpu",
                 f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}",
                 *extra])


def _read(root, out):
    return {rel: read_wav(str(root / out / rel)) for rel in FILES}


def test_cli_predict_lsgan_writes_mirrored_finite_wavs(wav_tree):
    summary = _predict(wav_tree, "out")
    assert summary["files"] == len(FILES) and "nfe" not in summary
    assert summary["audio_seconds"] == pytest.approx(sum(FILES.values()) / SR)
    for rel, (data, sr) in _read(wav_tree, "out").items():
        assert sr == SR and data.shape == (FILES[rel],) and np.isfinite(data).all()


def test_cli_predict_lsgan_loads_generator_state_dict(wav_tree):
    """ckpt_path= is a .pt state_dict of the generator's NCSN++; the CLI's
    output equals the generator's own enhance with those weights."""
    net = TGenerator(backbone="ncsnpp6M", device="cpu").net
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():  # unit-scale weights (the DDPM init zeroes output convs)
        for p in net.parameters():
            fan_in = p[0].numel() if p.dim() >= 2 else 100
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    ckpt = wav_tree / "g.pt"
    torch.save(net.state_dict(), ckpt)
    _predict(wav_tree, "out_seed")
    _predict(wav_tree, "out_ckpt", f"ckpt_path={ckpt}")
    seed_out, ckpt_out = _read(wav_tree, "out_seed"), _read(wav_tree, "out_ckpt")
    ref = TGenerator(backbone="ncsnpp6M", n_fft=254, hop_length=64, num_frames=32, device="cpu")
    ref.net.load_state_dict(net.state_dict())
    for rel in FILES:
        got, other = ckpt_out[rel][0], seed_out[rel][0]
        assert np.abs(got - other).max() > 1e-3 * np.abs(got).max()  # other weights
        wav, _ = read_wav(str(wav_tree / "in" / rel))
        # as the loader hands it over: peak 0.8, padded to a multiple of 16000
        wav = np.pad((wav / np.abs(wav).max() * 0.8).astype(np.float32), (0, -len(wav) % 16000))
        want = ref.forward_infer({"perturbed": torch.from_numpy(wav[None])})["fake"][0]
        want = want[:FILES[rel]].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    bad = wav_tree / "bad.pt"
    torch.save({"not_a_param": torch.zeros(1)}, bad)
    with pytest.raises(RuntimeError):
        _predict(wav_tree, "out_bad", f"ckpt_path={bad}")


def test_cli_rejects_generator_without_the_lsgan_interface(wav_tree, monkeypatch):
    from use_tpu_torch.models.registry import GeneratorRegistry

    class Bare:
        def __init__(self, **kw):
            pass

    monkeypatch.setitem(GeneratorRegistry._registry, "bare", Bare)
    with pytest.raises(SystemExit, match="lacks the LSGAN generator interface"):
        _predict(wav_tree, "out", "model.generator.name=bare")
