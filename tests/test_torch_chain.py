"""The hybrid chains of use_tpu_torch against use_tpu's, and the CLI's chain
dispatch on the CPU.

sgmse+gan: SGMSE enhances, the LSGAN generator refines the result.
gan+sgmse: the generator's output conditions the diffusion ('fake'), with
condition=both (a 6-channel score net) and sde_input=denoised.
Both stages get use_tpu's weights, converted, and the SGMSE stage replays
use_tpu's sampler draws. Tolerance: rtol 1e-4 and atol 1e-5 x max|ref| on
each stage's wav, as the generator's parity test (the random generator's
output reaches |50|, so an absolute limit would not scale). The CLI tests
check mirrored, length-matched, finite wavs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import jax_pc_noise, random_params, replay
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.engine.convert_jax import lsgan_params_to_state_dict, ncsnpp_params_to_state_dict
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel

NET = dict(nf=16, ch_mult=(1, 2, 2))
STFT = dict(n_fft=62, hop_length=16, num_frames=32)
SGMSE = dict(backbone="ncsnpp", sde="ouve", backbone_kwargs=NET, **STFT)
GAN = dict(backbone="ncsnpp", backbone_kwargs=NET, **STFT)
SR = 24000
FILES = {os.path.join("sub", "b.wav"): 6100}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(condition, sde_input, seed_sgmse=11, seed_gan=12):
    jm = JScoreModel(**SGMSE, condition=condition, sde_input=sde_input)
    sp = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed_sgmse)
    tm = TScoreModel(**SGMSE, condition=condition, sde_input=sde_input, device="cpu")
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(sp), strict=True)
    jg = JGenerator(**GAN)
    gp = random_params(jax.eval_shape(jg.init_params, jax.random.PRNGKey(0)), seed=seed_gan)
    tg = TGenerator(**GAN, device="cpu")
    tg.net.load_state_dict(lsgan_params_to_state_dict(gp), strict=True)
    return (jm, sp, JLSGAN(generator=jg), gp), (tm, TLSGAN(generator=tg))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _wav(seed, shape=(2, 700)):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_chain_sgmse_then_gan_matches_jax():
    (jm, sp, jl, gp), (tm, tl) = _pair("noisy", "noisy")
    wav = _wav(1)
    rng = jax.random.PRNGKey(5)
    enhanced = jm.sample(sp, {"perturbed": jnp.asarray(wav)}, rng, N=3)["enhanced"]
    want = np.asarray(jl.enhance(gp, {"perturbed": enhanced})["fake"])

    noise_fn, it = replay(jax_pc_noise(rng, 3, (2, 32, 64, 2), 0))
    stage1 = tm.sample({"perturbed": torch.from_numpy(wav)}, noise_fn=noise_fn, N=3)
    got = tl.enhance({"perturbed": stage1["enhanced"]})["fake"]
    assert next(it, None) is None
    assert got.shape == want.shape == (2, 700)
    _close(got.numpy(), want)


def test_chain_gan_then_sgmse_matches_jax():
    """condition=both, sde_input=denoised: the score net takes 6 channels
    (x, y, the GAN's output), so its first conv and its input_skip pyramid
    are wider; the converted weights load strictly."""
    (jm, sp, jl, gp), (tm, tl) = _pair("both", "denoised")
    assert tm.score_net.cfg.input_channels == 6
    assert tm.score_net.all_modules[3].weight.shape[1] == 6  # the first 3x3 conv
    wav = _wav(2)
    rng = jax.random.PRNGKey(6)
    fake = jl.enhance(gp, {"perturbed": jnp.asarray(wav)})["fake"]
    want = np.asarray(jm.sample(sp, {"perturbed": jnp.asarray(wav), "fake": fake}, rng,
                                N=3)["fake_sde_enhanced"])

    tfake = tl.enhance({"perturbed": torch.from_numpy(wav)})["fake"]
    _close(tfake.numpy(), fake)
    noise_fn, it = replay(jax_pc_noise(rng, 3, (2, 32, 64, 2), 0))
    out = tm.sample({"perturbed": torch.from_numpy(wav), "fake": tfake}, noise_fn=noise_fn, N=3)
    assert next(it, None) is None
    assert "enhanced" not in out
    assert out["fake_sde_enhanced"].shape == want.shape == (2, 700)
    _close(out["fake_sde_enhanced"].numpy(), want)


def _write_tree(root):
    rng = np.random.default_rng(0)
    for rel, n in FILES.items():
        write_wav(str(root / "in" / rel), (0.1 * rng.standard_normal(n)).astype(np.float32), SR)
    return root


@pytest.fixture
def wav_tree(tmp_path):
    return _write_tree(tmp_path)


def _predict(root, out, experiment, *extra):
    return main(["predict", f"experiment={experiment}", "device=cpu", "infer.N=1",
                 f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}",
                 *extra])


def _check_outputs(root, out):
    outs = {}
    for rel, n in FILES.items():
        data, sr = read_wav(str(root / out / rel))
        assert sr == SR and data.shape == (n,) and np.isfinite(data).all()
        outs[rel] = data
    return outs


GAN_FIRST = ("predict.chain=gan+sgmse", "predict.second_experiment=SGMSE_debug",
             "second.model.condition=both", "second.model.sde_input=denoised")


def test_cli_chain_sgmse_then_gan(wav_tree):
    summary = _predict(wav_tree, "out", "SGMSE_debug", "predict.chain=sgmse+gan",
                       "predict.second_experiment=LSGAN_debug")
    assert (summary["files"], summary["nfe"]) == (len(FILES), len(FILES))
    _check_outputs(wav_tree, "out")


@pytest.fixture(scope="module")
def gan_first_run(tmp_path_factory):
    """The CLI's gan+sgmse chain on the seeded weights of both stages, run
    once for the tests that read it; -> (its tree, its summary)."""
    root = _write_tree(tmp_path_factory.mktemp("gan_first"))
    return root, _predict(root, "out", "LSGAN_debug", *GAN_FIRST)


def test_cli_chain_gan_then_sgmse(gan_first_run):
    wav_tree, summary = gan_first_run
    assert (summary["files"], summary["nfe"]) == (len(FILES), len(FILES))
    _check_outputs(wav_tree, "out")


def test_cli_chain_loads_both_checkpoints(gan_first_run):
    """ckpt_path= loads the first stage's net, predict.second_ckpt= the
    second's (here the 6-channel score net of condition=both); against the
    seeded run (gan_first_run's "out")."""
    wav_tree = gan_first_run[0]
    first = TGenerator(backbone="ncsnpp6M", device="cpu", seed=3).net
    second = TScoreModel(backbone="ncsnpp6M", condition="both", device="cpu", seed=4).score_net
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # unit-scale weights (the DDPM init zeroes output convs)
        for net in (first, second):
            for p in net.parameters():
                if p.dim() >= 2:
                    p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
    torch.save(first.state_dict(), wav_tree / "g.pt")
    torch.save(second.state_dict(), wav_tree / "s.pt")
    _predict(wav_tree, "out_g", "LSGAN_debug", *GAN_FIRST, f"ckpt_path={wav_tree / 'g.pt'}")
    _predict(wav_tree, "out_gs", "LSGAN_debug", *GAN_FIRST, f"ckpt_path={wav_tree / 'g.pt'}",
             f"predict.second_ckpt={wav_tree / 's.pt'}")
    base = _check_outputs(wav_tree, "out")
    with_g, with_both = _check_outputs(wav_tree, "out_g"), _check_outputs(wav_tree, "out_gs")
    for rel in FILES:
        assert not np.array_equal(with_g[rel], base[rel])
        assert not np.array_equal(with_both[rel], with_g[rel])

    bad = TScoreModel(backbone="ncsnpp6M", condition="noisy", device="cpu").score_net
    torch.save(bad.state_dict(), wav_tree / "bad.pt")
    with pytest.raises(RuntimeError):  # a 4-channel net's weights do not fit condition=both
        _predict(wav_tree, "out_bad", "LSGAN_debug", *GAN_FIRST,
                 f"predict.second_ckpt={wav_tree / 'bad.pt'}")


def test_cli_gan_then_sgmse_samples_the_full_clip(tmp_path, monkeypatch):
    """A clip of >= 5 s is chunked into lanes on the SGMSE-only path, but
    not when a GAN output conditions the sampler (use_tpu's `"fake" not in
    batch`). 8 kHz audio keeps the 5 s clip small."""
    sr = 8000
    write_wav(str(tmp_path / "in" / "long.wav"),
              (0.1 * np.random.default_rng(1).standard_normal(5 * sr)).astype(np.float32), sr)
    calls = []
    real = TScoreModel.sample_chunked

    def spy(self, *args, **kw):
        calls.append(self.condition)
        return real(self, *args, **kw)

    monkeypatch.setattr(TScoreModel, "sample_chunked", spy)
    _predict(tmp_path, "sg", "SGMSE_debug", f"data.sampling_rate={sr}")
    assert calls == ["noisy"]
    _predict(tmp_path, "gs", "LSGAN_debug", f"data.sampling_rate={sr}", *GAN_FIRST)
    assert calls == ["noisy"]
    data, got_sr = read_wav(str(tmp_path / "gs" / "long.wav"))
    assert got_sr == sr and data.shape == (5 * sr,) and np.isfinite(data).all()


@pytest.mark.parametrize("argv", [
    ["predict.chain=sgmse+gan"],  # no second experiment
    ["predict.chain=gan+sgmse", "predict.second_experiment=LSGAN_debug"],  # tasks reversed
    ["predict.chain=gan+gan", "predict.second_experiment=LSGAN_debug"],
])
def test_cli_rejects_malformed_chains(wav_tree, argv):
    with pytest.raises(SystemExit, match="predict.chain"):
        _predict(wav_tree, "out", "SGMSE_debug", *argv)


@pytest.mark.parametrize("sampler", [
    ("infer.sampler_type=ode", "infer.N=1"),
    ("infer.sampler_type=parallel_pc", "infer.N=2", "infer.window=2", "infer.tol=0.1"),
])
def test_cli_predict_with_ode_and_parallel_samplers(wav_tree, sampler):
    """The summary reports the sampler's evaluations: ode 4N + 1 a file;
    parallel_pc sweeps x W, with W = min(window, N)."""
    summary = _predict(wav_tree, "out", "SGMSE_debug", *sampler)
    _check_outputs(wav_tree, "out")
    if sampler[0].endswith("ode"):
        assert summary["nfe"] == 5 * len(FILES) and "sweeps" not in summary
    else:
        assert summary["nfe"] == 2 * summary["sweeps"]
        assert len(FILES) <= summary["sweeps"] <= 2 * len(FILES)


def test_cli_streaming_is_not_ported(wav_tree):
    """Streaming is ported for the csmgan generator only
    (tests/test_torch_csmgan.py): the LSGAN generator is refused up front
    with use_tpu's message, as is a chain."""
    with pytest.raises(SystemExit, match="streamable generator"):
        _predict(wav_tree, "out", "LSGAN_debug", "predict.streaming=true")
    with pytest.raises(SystemExit, match="streamable generator"):
        _predict(wav_tree, "out", "LSGAN_debug", "predict.streaming=true",
                 "predict.chain=gan+sgmse", "predict.second_experiment=SGMSE_debug")
