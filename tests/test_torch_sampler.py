"""SDE and sampler parity: use_tpu_torch.models.sgmse against use_tpu's.

The wav -> wav tests share weights (converted) and the sampling noise: the
JAX sampler's own draws are replayed into the port's `noise_fn` in the order
the port consumes them, per step: `split(rng, 3)` -> crandn(rz)
(sampling.py:151-159), then the corrector's `split(rc)` draws
(sampling.py:98-100). Tolerance atol 1e-4 on the wav."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import jax_pc_noise, random_params, replay
from use_tpu.models.sgmse import sdes as jsdes
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.sgmse import sdes as tsdes
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel

TINY = dict(backbone="ncsnpp", sde="ouve", condition="noisy", sde_input="noisy",
            n_fft=62, hop_length=16, num_frames=32,
            backbone_kwargs=dict(nf=16, ch_mult=(1, 2, 2)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["ouve", "ouvp"])
def test_sde_marginals_match_jax(name):
    rng = np.random.default_rng(0)
    t = np.linspace(0.03, 1.0, 5).astype(np.float32)
    x0 = rng.standard_normal((5, 3, 4, 2)).astype(np.float32)
    y = rng.standard_normal((5, 3, 4, 2)).astype(np.float32)
    sj = {"ouve": jsdes.OUVESDE, "ouvp": jsdes.OUVPSDE}[name]()
    st = {"ouve": tsdes.OUVESDE, "ouvp": tsdes.OUVPSDE}[name]()
    mean_j, std_j = sj.marginal_prob(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(y))
    mean_t, std_t = st.marginal_prob(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-5, atol=1e-7)
    drift_j, diff_j = sj.sde(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(y))
    drift_t, diff_t = st.sde(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(drift_t.numpy(), np.asarray(drift_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(diff_t.numpy(), np.asarray(diff_j), rtol=1e-5)
    z = tsdes.crandn((4000,), torch.Generator().manual_seed(0))
    assert abs(float(z.var()) - 0.5) < 0.05


def _models(corrector):
    jm = JScoreModel(**TINY, corrector=corrector)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = random_params(shapes, seed=11)
    tm = TScoreModel(**TINY, corrector=corrector, device="cpu")
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("corrector", ["none", "ald"])
def test_sample_wav_matches_jax(corrector):
    jm, params, tm = _models(corrector)
    wav = (0.1 * np.random.default_rng(1).standard_normal((2, 700))).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    kw = dict(N=5, corrector_steps=1, snr=0.5)
    want = np.asarray(jm.sample(params, {"perturbed": jnp.asarray(wav)}, rng, **kw)["enhanced"])

    n_corr = 0 if corrector == "none" else 1
    noise_fn, it = replay(jax_pc_noise(rng, 5, (2, 32, 64, 2), n_corr))
    got = tm.sample({"perturbed": torch.from_numpy(wav)}, noise_fn=noise_fn, **kw)["enhanced"]
    assert next(it, None) is None  # every draw consumed
    assert got.shape == want.shape == (2, 700)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_sample_chunked_matches_jax():
    jm, params, tm = _models("none")
    wav = (0.1 * np.random.default_rng(2).standard_normal((1, 1500))).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    kw = dict(n_chunks=2, overlap_frames=4, N=3)
    want = np.asarray(
        jm.sample_chunked(params, {"perturbed": jnp.asarray(wav)}, rng, **kw)["enhanced"]
    )
    noise_fn, it = replay(jax_pc_noise(rng, 3, (2, 32, 64, 2), 0))
    got = tm.sample_chunked({"perturbed": torch.from_numpy(wav)}, noise_fn=noise_fn, **kw)
    assert next(it, None) is None
    assert got["enhanced"].shape == want.shape == (1, 1500)
    np.testing.assert_allclose(got["enhanced"].numpy(), want, atol=1e-4)
