"""The legacy sp-uhh model family in use_tpu_torch against use_tpu's, on the
CPU, at use_tpu's own TINY widths (tests/test_legacy_models.py): the EMA,
LegacyScoreModel.enhance with timeit, DiscriminativeModel's loss and
enhance, StochasticRegenerationModel's loss and enhance, each on use_tpu's
random weights carried by engine/convert_jax.py and use_tpu's draws (the
crops, t and z of the losses; the sampler's noise replayed).
tests/test_torch_legacy_cli.py holds the CLI's refusals and chip_smoke's
launch constants of the regeneration.

Tolerances: losses within 1e-5 relative; wavs within 1e-5 of their largest
|value|, rtol 1e-4, as tests/test_torch_chain.py holds the chains (fp32;
the frameworks sum convolutions in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import jax_pc_noise, random_params, replay
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.sgmse import legacy as jlegacy
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu.models.sgmse.sdes import crandn as jcrandn
from use_tpu_torch.engine.convert_jax import lsgan_params_to_state_dict, ncsnpp_params_to_state_dict
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.sgmse import legacy as tlegacy
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel

TINY = dict(
    backbone="ncsnpp", n_fft=126, hop_length=32, num_frames=32,
    backbone_kwargs=dict(nf=8, ch_mult=(1, 1), num_res_blocks=1),
)
LENGTH = 2000
SPEC = (64, 64, 2)  # 2000 samples at hop 32: 63 frames, padded to 64; 64 bins


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal((1, LENGTH))).astype(np.float32)
            for k in ("clean", "perturbed")}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _generator_pair(seed):
    jg = JGenerator(**TINY)
    params = random_params(jax.eval_shape(jg.init_params, jax.random.PRNGKey(0)), seed=seed)
    tg = TGenerator(**TINY, device="cpu")
    tg.net.load_state_dict(lsgan_params_to_state_dict(params), strict=True)
    return jg, params, tg


def _score_pair(seed, cls_j=JScoreModel, cls_t=TScoreModel, **kw):
    jm = cls_j(**TINY, **kw)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)
    tm = cls_t(**TINY, **kw, device="cpu")
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    return jm, params, tm


def _score_draws(jm, rng, n, length):
    """use_tpu train_loss's (start, t, z) for `rng` (score_model.py:153-171)."""
    rng_crop, rng_t, rng_z = jax.random.split(rng, 3)
    start = int(jax.random.randint(rng_crop, (), 0, max(length - jm.target_len, 1)))
    t = jax.random.uniform(rng_t, (n,)) * (jm.sde_obj.T - jm.t_eps) + jm.t_eps
    z = jcrandn(rng_z, (n, jm.stft_cfg.freqs, jm.num_frames, 2))
    return start, torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def test_ema_matches_jax():
    """torch_ema: ema = d ema + (1 - d) p after each step, over a state_dict,
    as use_tpu's over a pytree; the EMA holds copies, not the weights."""
    p0 = {"w": np.zeros(3, np.float32), "b": np.full(2, 2.0, np.float32)}
    p1 = {"w": np.ones(3, np.float32), "b": np.full(2, -1.0, np.float32)}
    je, te = jlegacy.EMA(decay=0.9), tlegacy.EMA(decay=0.9)
    jstate = je.init({k: jnp.asarray(v) for k, v in p0.items()})
    weights = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = te.init(weights)
    weights["w"].add_(5.0)
    assert float(tstate["w"].sum()) == 0.0
    for _ in range(2):
        jstate = je.update(jstate, {k: jnp.asarray(v) for k, v in p1.items()})
        tstate = te.update(tstate, {k: torch.from_numpy(v) for k, v in p1.items()})
    for k in p0:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-7)
    np.testing.assert_allclose(tstate["w"].numpy(), 0.19 * np.ones(3), atol=1e-7)
    assert tlegacy.LegacyScoreModel(**TINY, device="cpu", ema_decay=0.5).ema.decay == 0.5


def test_legacy_score_model_enhance_timeit_matches_jax():
    jm, params, tm = _score_pair(21, jlegacy.LegacyScoreModel, tlegacy.LegacyScoreModel,
                                 condition="noisy", sde_input="noisy")
    y = (0.1 * np.random.default_rng(0).standard_normal(LENGTH)).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    want, jnfe, _ = jm.enhance(params, jnp.asarray(y), rng, N=3, timeit=True)

    noise = jax_pc_noise(rng, 3, (1,) + SPEC, 0)
    noise_fn, it = replay(noise)
    x_hat, nfe, rtf = tm.enhance(torch.from_numpy(y), noise_fn=noise_fn, N=3, timeit=True)
    assert next(it, None) is None
    assert x_hat.shape == y.shape and (nfe, jnfe) == (3, 3) and rtf > 0
    _close(x_hat.numpy(), want)
    # batched, no timing: the same samples
    batched = tm.enhance(torch.from_numpy(y)[None], noise_fn=replay(noise)[0], N=3)
    assert batched.shape == (1, LENGTH)
    np.testing.assert_allclose(batched[0].numpy(), x_hat.numpy(), atol=1e-6)


def test_discriminative_model_loss_and_enhance_match_jax():
    jm = jlegacy.DiscriminativeModel(**TINY)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=22)
    tm = tlegacy.DiscriminativeModel(**TINY, device="cpu")
    tm.wrapper.net.load_state_dict(lsgan_params_to_state_dict(params), strict=True)
    batch = _batch(1)
    rng = jax.random.PRNGKey(2)
    want = float(jax.jit(jm.train_loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                        rng))
    start = int(jax.random.randint(rng, (), 0, max(LENGTH - jm.wrapper.target_len, 1)))
    loss = tm.train_loss(_t(batch), start=start)
    assert loss.requires_grad
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)

    want = jax.jit(jm.enhance)(params, jnp.asarray(batch["perturbed"]))
    got = tm.enhance(torch.from_numpy(batch["perturbed"]))
    assert got.shape == (1, LENGTH)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def regeneration():
    """use_tpu's and the port's StochasticRegenerationModel on one set of
    random weights: the TINY generator as denoiser, the TINY score model
    with condition='both', sde_input='denoised'."""
    jg, gp, tg = _generator_pair(23)
    js, sp, ts = _score_pair(24, condition="both", sde_input="denoised")
    jm = jlegacy.StochasticRegenerationModel(denoiser=jg, score=js)
    tm = tlegacy.StochasticRegenerationModel(denoiser=tg, score=ts)
    return jm, (gp, sp), tm


def test_stochastic_regeneration_loss_matches_jax(regeneration):
    """use_tpu splits one rng into the denoiser's crop and the score loss's
    crop, t and z: the port takes the same draws."""
    jm, params, tm = regeneration
    batch = _batch(3)
    rng = jax.random.PRNGKey(3)
    want = float(jax.jit(jm.train_loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                        rng))
    r1, r2 = jax.random.split(rng)
    start = int(jax.random.randint(r1, (), 0, max(LENGTH - jm.denoiser.target_len, 1)))
    draws = _score_draws(jm.score, r2, 1, jm.denoiser.target_len)
    loss = tm.train_loss(_t(batch), start=start, draws=draws)
    assert loss.requires_grad
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)


def test_stochastic_regeneration_enhance_matches_jax(regeneration):
    jm, params, tm = regeneration
    y = _batch(4)["perturbed"]
    rng = jax.random.PRNGKey(4)
    want = jax.jit(lambda p, y, r: jm.enhance(p, y, r, N=3))(params, jnp.asarray(y), rng)
    noise_fn, it = replay(jax_pc_noise(rng, 3, (1,) + SPEC, 0))
    got = tm.enhance(torch.from_numpy(y), noise_fn=noise_fn, N=3)
    assert next(it, None) is None
    assert got.shape == (1, LENGTH)
    _close(got.numpy(), want)
