"""bf16 training of use_tpu_torch against use_tpu's, on the CPU.

``backbone_kwargs.dtype=bfloat16`` under training (use_tpu's LSGAN recipe
documents it, config/experiments/LSGAN.yaml:5-10): the weights stay
float32, the convolutions, K1's apply and K2 compute in bf16 under
autograd, and no serving cast runs. The train loss and its gradients on
use_tpu's own draws, and one LSGAN step's losses and summed gradients on
its crop, against use_tpu's bf16 on the same weights.

Tolerances, from seeds (a tiny NCSN++ of 16 channels): the two
frameworks round in other places (use_tpu keeps its backward in bf16
through XLA; the port's K2 backward accumulates in fp32, its convs'
weight gradients sum in fp32), so their bf16 gradients differ as much as
use_tpu's bf16 differs from its fp32. Measured as the L2 norm of the whole
gradient's difference over the reference's, seeds 0-2: port bf16 against
use_tpu bf16 0.028 / 0.033 / 0.083 (use_tpu bf16 against its fp32 0.027 /
0.034 / 0.086), port bf16 against the fp32 gradient 0.0100 / 0.0069 /
0.0078; limits 0.15 and 0.03. A broken control, K2's bf16 backward
without its 1/sqrt(2), reads 1.95 against the fp32 gradient. The loss
within 1e-3 (readings <= 2.1e-4).
LSGAN at seed 0 (its bf16 step compiles in ~30 s): G 0.035 and D 0.0054
against use_tpu's bf16 (0.028-0.065 and 0.0024-0.050 over seeds 0-2),
limit 0.15; loss_D within 1e-2 (readings <= 1.9e-3), loss_G within 2e-2
(readings <= 6.4e-3: its STFT terms of the bf16 fake).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from tests.test_torch_gan_train import CLIP, GEN, STEP_LOSS, JTinyD, TTinyD
from tests.test_torch_train import TINY, TINY_KWARGS, TINY_LEN, _batch, _tensors, jax_draws
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import TrainState as JTrainState
from use_tpu.models.gan import losses as jlosses
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu_torch.engine import optim as toptim
from use_tpu_torch.engine.convert_jax import (
    discriminator_params_to_state_dict,
    lsgan_params_to_state_dict,
    ncsnpp_params_to_state_dict,
)
from use_tpu_torch.engine.loop import build_gan_train_state
from use_tpu_torch.engine.state import TrainState
from use_tpu_torch.engine.train import gan_train_step, sgmse_train_step
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel
from use_tpu_torch.ops import fused_skip

BF16 = dict(TINY_KWARGS, dtype="bfloat16")
L2_JAX_BF16 = 0.15  # port bf16 against use_tpu bf16
L2_EXACT = 0.03  # port bf16 against the fp32 gradient


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _l2(got, want):
    """|got - want| / |want| over every tensor of `want` together."""
    keys = sorted(want)
    a = torch.cat([got[k].float().flatten() for k in keys])
    b = torch.cat([torch.as_tensor(np.array(want[k])).float().flatten() for k in keys])
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def jax_bf16_grads():
    jm = JScoreModel(**TINY, backbone_kwargs=BF16)
    return jm, jax.jit(jax.value_and_grad(jm.train_loss))


def _port_step(params, kwargs, batch, draws):
    """One sgmse_train_step of the port (lr 0: the weights stay); -> (loss,
    {name: the gradient it applied}, the net)."""
    tm = TScoreModel(**TINY, device="cpu", backbone_kwargs=kwargs)
    net = tm.score_net
    net.load_state_dict(ncsnpp_params_to_state_dict(params))
    state = TrainState.create(net, toptim.adam(toptim.trainable(net), 0.0, 0.0))
    seen = {}
    real = state.apply_gradients

    def record():
        seen.update({k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None})
        real()

    state.apply_gradients = record
    loss = sgmse_train_step(tm, state, [_tensors(batch)], draws=[draws])["loss_Score"]
    return float(loss), seen, net


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_train_loss_and_gradients_match_jax_bf16(jax_bf16_grads, seed):
    """The bf16 loss and gradients on use_tpu's draws against use_tpu's bf16
    (L2_JAX_BF16) and against the port's fp32, which equals use_tpu's fp32
    (tests/test_torch_train.py) (L2_EXACT); the weights stay float32."""
    jm, grads_fn = jax_bf16_grads
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=6 + seed)
    batch = _batch(3 + seed, length=TINY_LEN)
    rng = jax.random.PRNGKey(7 + seed)
    loss_j, grads_j = grads_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    grads_j = ncsnpp_params_to_state_dict(jax.device_get(grads_j))
    grads_j.pop("all_modules.0.W")  # frozen (use_tpu's stop_gradient)
    draws = jax_draws(jm, rng, batch)
    loss, grads, net = _port_step(params, BF16, batch, draws)
    _, exact, _ = _port_step(params, TINY_KWARGS, batch, draws)
    assert net.cdtype == torch.bfloat16
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert abs(loss - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    assert set(grads) == set(grads_j)
    assert _l2(grads, grads_j) <= L2_JAX_BF16
    assert _l2(grads, exact) <= L2_EXACT


def test_bf16_gradient_gate_fails_a_broken_k2_backward(jax_bf16_grads, monkeypatch):
    """The control: K2's bf16 backward without its skip_rescale factor
    (1/sqrt(2)) exceeds L2_EXACT."""
    jm, _ = jax_bf16_grads
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=6)
    batch = _batch(3, length=TINY_LEN)
    draws = jax_draws(jm, jax.random.PRNGKey(7), batch)
    _, exact, _ = _port_step(params, TINY_KWARGS, batch, draws)
    backward = fused_skip._FusedSkipAdd.backward

    def unscaled(ctx, dy):
        scale, ctx.scale = ctx.scale, 1.0
        try:
            return backward(ctx, dy)
        finally:
            ctx.scale = scale

    monkeypatch.setattr(fused_skip._FusedSkipAdd, "backward", staticmethod(unscaled))
    _, broken, _ = _port_step(params, BF16, batch, draws)
    assert _l2(broken, exact) > L2_EXACT


def test_bf16_gan_train_step_matches_jax_bf16():
    """One LSGAN step with a bf16 generator on use_tpu's crop: D's and G's
    gradients (G's against the stepped D) against use_tpu's bf16, L2 within
    L2_JAX_BF16; the losses within 1e-2 (loss_D) and 2e-2 (loss_G)."""
    gen = dict(GEN, backbone_kwargs=dict(GEN["backbone_kwargs"], dtype="bfloat16"))
    jgan = JLSGAN(generator=JGenerator(**gen), discriminator=JTinyD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_shape, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), CLIP))
    gp, dp = random_params(g_shape, seed=1), random_params(d_shape, seed=2)
    rng = np.random.default_rng(10)
    clean = (0.3 * rng.standard_normal((2, CLIP))).astype(np.float32)
    batch = {"clean": clean,
             "perturbed": (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)}
    r = jax.random.split(jax.random.PRNGKey(3), 1)[0]

    tgan = TLSGAN(generator=TGenerator(**gen, device="cpu"), discriminator=TTinyD(),
                  g_loss_cfg=dict(STEP_LOSS))
    tgan.generator.net.load_state_dict(lsgan_params_to_state_dict(gp))
    tgan.discriminator.load_state_dict(discriminator_params_to_state_dict(dp))
    state = build_gan_train_state(tgan, 5e-4, 2e-4, 1e-7)
    seen = {}
    for name, st in (("d", state.d), ("g", state.g)):
        real = st.apply_gradients

        def record(name=name, st=st, real=real):
            seen[name] = {k: p.grad.clone() for k, p in st.model.named_parameters()
                          if p.grad is not None}
            real()

        st.apply_gradients = record
    start = int(jax.random.randint(r, (), 0, CLIP - 496))
    out = gan_train_step(tgan, state, [{k: torch.from_numpy(v) for k, v in batch.items()}],
                         starts=[start])
    assert {p.dtype for p in tgan.generator.net.parameters()} == {torch.float32}
    d_tx = joptim.adam(2e-4, 1e-7, params_example=dp)

    @jax.jit
    def grads(gp, dp, mb, r):  # use_tpu's D phase, D's Adam step, then its G phase
        fake = jax.lax.stop_gradient(jgan.g_forward(gp, mb, r))
        ld, gd = jax.value_and_grad(jgan.d_loss)(dp, fake)
        new_dp = JTrainState.create(dp, d_tx).apply_gradients(gd, d_tx).params
        lg, gg = jax.value_and_grad(lambda p: jgan.g_loss(new_dp, jgan.g_forward(p, mb, r))[0])(gp)
        return ld, gd, lg, gg

    ld, gd, lg, gg = grads(gp, dp, {k: jnp.asarray(v) for k, v in batch.items()}, r)
    assert abs(float(out["loss_D"]) - float(ld)) <= 1e-2 * abs(float(ld))
    assert abs(float(out["loss_G"]) - float(lg)) <= 2e-2 * abs(float(lg))
    assert _l2(seen["d"], discriminator_params_to_state_dict(jax.device_get(gd))) <= L2_JAX_BF16
    assert _l2(seen["g"], lsgan_params_to_state_dict(jax.device_get(gg))) <= L2_JAX_BF16

