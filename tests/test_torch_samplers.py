"""The ODE, adaptive ODE and parallel PC samplers of use_tpu_torch against
use_tpu's, and ScoreModel's dispatch to them.

Both sides get the same converted weights and the same noise: the port's
sources replay use_tpu's JAX draws (the prior's crandn(rng) for the ODE
samplers; crandn(fold_in(split(rng)[0], p)) at trajectory position p for
parallel_pc). Tolerances: atol 1e-4 on wavs and spectra, as the PC sampler's
parity tests; sweep and evaluation counts exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import jax_position_noise, random_params, replay
from use_tpu.models.sgmse import sampling as jsampling
from use_tpu.models.sgmse import sdes as jsdes
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.sgmse import sampling as tsampling
from use_tpu_torch.models.sgmse import sdes as tsdes
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel

TINY = dict(backbone="ncsnpp", sde="ouve", condition="noisy", sde_input="noisy",
            n_fft=62, hop_length=16, num_frames=32,
            backbone_kwargs=dict(nf=16, ch_mult=(1, 2, 2)))
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(seed=11):
    jm = JScoreModel(**TINY)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)
    tm = TScoreModel(**TINY, device="cpu")
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    return jm, params, tm


def _spec(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_ode_sampler_wav_matches_jax():
    """RK4, N=2: 4N + 1 = 9 evaluations; the prior replays use_tpu's draw."""
    jm, params, tm = _models()
    wav = (0.1 * np.random.default_rng(1).standard_normal((2, 700))).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jm.sample(params, {"perturbed": jnp.asarray(wav)}, rng,
                                sampler_type="ode", N=2)["enhanced"])
    noise_fn, it = replay([np.array(jsdes.crandn(rng, (2, 32, 64, 2)))])
    out = tm.sample({"perturbed": torch.from_numpy(wav)}, noise_fn=noise_fn,
                    sampler_type="ode", N=2)
    assert next(it, None) is None
    assert out["nfe"] == 9
    assert out["enhanced"].shape == want.shape == (2, 700)
    np.testing.assert_allclose(out["enhanced"].numpy(), want, atol=ATOL)


@pytest.mark.parametrize("tol", [0.0, 0.1])
def test_parallel_pc_matches_jax(tol):
    """Batch 2, N=4, W=3 through sample_spec (window-major conditioning):
    the same evaluations (sweeps x W) and the same sample."""
    jm, params, tm = _models()
    y = _spec((2, 32, 64, 2), seed=2)
    rng = jax.random.PRNGKey(9)
    kw = dict(sampler_type="parallel_pc", N=4, window=3, tol=tol)
    want, want_nfe = jm.sample_spec(params, jnp.asarray(y), rng, [jnp.asarray(y)], **kw)
    yt = torch.from_numpy(y)
    with torch.inference_mode():
        got, counts = tm.sample_spec(yt, [yt], noise_at=jax_position_noise(rng, y.shape), **kw)
    assert counts["nfe"] == int(want_nfe) == 3 * counts["sweeps"]
    if tol == 0.0:
        assert counts["sweeps"] == 4  # advance by one: N sweeps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_parallel_pc_at_zero_tol_is_the_sequential_pc_trajectory():
    """tol=0: the port's parallel sampler equals its own PC sampler fed the
    same per-position noise in order (positions 0 .. N-1; the last step is
    the noiseless mean)."""
    _, _, tm = _models()
    y = torch.from_numpy(_spec((2, 32, 64, 2), seed=3))
    noise_at = jax_position_noise(jax.random.PRNGKey(4), tuple(y.shape))
    n = 3
    with torch.inference_mode():
        par, par_counts = tm.sample_spec(y, [y], noise_at=noise_at, sampler_type="parallel_pc",
                                         N=n, window=3, tol=0.0)
        noise_fn, it = replay([noise_at(p).numpy() for p in range(n)])
        seq, seq_counts = tm.sample_spec(y, [y], noise_fn=noise_fn, sampler_type="pc", N=n)
    assert next(it, None) is None
    assert par_counts == {"nfe": n * 3, "sweeps": n} and seq_counts == {"nfe": n}
    np.testing.assert_allclose(par.numpy(), seq.numpy(), atol=1e-5)


def _linear_score(y, std_fn, batch, xp):
    """The Gaussian-posterior score -(x - y) / std(t)^2 of use_tpu's
    test_parallel_sampler.py: contractive, so the window slides faster
    than one position a sweep."""
    def score_fn(x, t):
        k = x.shape[0] // batch
        yt = xp.tile(y, (k, 1, 1, 1))
        std = std_fn(t).reshape((-1, 1, 1, 1))
        return -(x - yt) / (std * std + 1e-4)
    return score_fn


def test_parallel_pc_linear_score_matches_jax_in_fewer_sweeps():
    y = np.random.default_rng(5).standard_normal((2, 6, 5, 2)).astype(np.float32)
    n, w = 16, 8
    rng = jax.random.PRNGKey(3)
    jsde, tsde = jsdes.OUVESDE(N=n), tsdes.OUVESDE(N=n)
    jfn = _linear_score(jnp.asarray(y), jsde._std, 2, jnp)
    tfn = _linear_score(torch.from_numpy(y), tsde._std, 2, torch)
    want, want_nfe = jsampling.get_parallel_pc_sampler(
        "reverse_diffusion", "none", jsde, jfn, jnp.asarray(y), tol=0.1, window=w)(rng)
    got, nfe, sweeps = tsampling.get_parallel_pc_sampler(
        "reverse_diffusion", "none", tsde, tfn, torch.from_numpy(y), tol=0.1, window=w,
    )(noise_at=jax_position_noise(rng, y.shape))
    assert nfe == int(want_nfe) == sweeps * w < n * w
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ode_sampler_adaptive_matches_jax():
    """scipy RK45 on the host over the tiny net's drift: the same number of
    evaluations and the same sample, at rtol = atol = 1e-3. (At the default
    1e-5 the step control works at the float32 drift's rounding: the two
    frameworks' drifts differ at ~1e-6 here, and each side's accepted steps
    follow its own rounding.)"""
    jm, params, tm = _models()
    y = _spec((1, 32, 16, 2), seed=6)
    rng = jax.random.PRNGKey(2)
    jsde, tsde = jm.sde_obj.copy(N=30), tm.sde_obj.copy(N=30)
    want, want_nfe = jsampling.get_ode_sampler_adaptive(
        jsde, lambda xt, t: jm.forward_score(params, xt, t, [jnp.asarray(y)]), jnp.asarray(y),
        eps=jm.t_eps, rtol=1e-3, atol=1e-3)(rng)
    yt = torch.from_numpy(y)
    noise_fn, it = replay([np.array(jsdes.crandn(rng, y.shape))])
    with torch.inference_mode():
        got, nfe = tsampling.get_ode_sampler_adaptive(
            tsde, lambda xt, t: tm.forward_score(xt, t, [yt]), yt, eps=tm.t_eps, rtol=1e-3,
            atol=1e-3,
        )(noise_fn=noise_fn)
    assert next(it, None) is None
    assert nfe == want_nfe
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sample_spec_tiles_conditioning_window_major():
    """parallel_pc feeds the net batch W*B; slot k*B + b is conditioned on
    y[b] (the sampler's [W, B] -> [W*B] order)."""
    _, _, tm = _models()
    y = torch.from_numpy(_spec((2, 32, 64, 2), seed=7))
    seen = []
    real = tm.score_net.forward

    def record(x, t):
        seen.append(x.clone())
        return real(x, t)

    tm.score_net.forward = record
    with torch.inference_mode():
        tm.sample_spec(y, [y], generator=torch.Generator().manual_seed(0),
                       sampler_type="parallel_pc", N=3, window=3, tol=0.0)
    assert len(seen) == 3 and all(x.shape == (6, 32, 64, 4) for x in seen)
    for x in seen:
        for k in range(3):
            torch.testing.assert_close(x[2 * k:2 * k + 2, ..., 2:], y, rtol=0, atol=0)


def test_sample_spec_rejects_unknown_sampler_and_parallel_corrector():
    _, _, tm = _models()
    y = torch.zeros((1, 32, 64, 2))
    with pytest.raises(ValueError, match="not a valid sampler"):
        tm.sample_spec(y, [y], sampler_type="bogus", N=2)
    with pytest.raises(ValueError, match="corrector='none' only"):
        tsampling.get_parallel_pc_sampler("reverse_diffusion", "ald", tm.sde_obj, None, y)


def test_default_noise_sources_draw_from_the_generator():
    """Without a replayed source each sampler draws from its torch.Generator:
    the same seed gives the same sample, another seed another."""
    _, _, tm = _models()
    y = torch.from_numpy(_spec((1, 32, 16, 2), seed=8))
    for kw in (dict(sampler_type="ode", N=1),
               dict(sampler_type="parallel_pc", N=2, window=2, tol=0.1)):
        with torch.inference_mode():
            a = tm.sample_spec(y, [y], torch.Generator().manual_seed(1), **kw)[0]
            b = tm.sample_spec(y, [y], torch.Generator().manual_seed(1), **kw)[0]
            c = tm.sample_spec(y, [y], torch.Generator().manual_seed(2), **kw)[0]
        assert torch.equal(a, b) and not torch.allclose(a, c)
