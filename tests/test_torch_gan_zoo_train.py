"""LSGAN training with the 24k bank (MPD, MSD, MMD) in use_tpu_torch against
use_tpu's, on the CPU.

One gan_train_step against use_tpu's make_gan_train_step on use_tpu's crop
draw, as tests/test_torch_gan_train.py::test_gan_train_step_matches_jax
does for the 24k_MVD bank (a 16-channel generator over two levels, the
bank at its default widths on white-noise clips; the same tolerances,
argued there), and chip_smoke's launch constants for gan24k_train_step
counted on a microbatch with the bank; tests/test_torch_gan_zoo_cli.py
holds the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from tests.test_torch_gan_train import (
    CLIP,
    GEN,
    STEP_LOSS,
    _adam_step_close,
    _batch,
    _grads_close,
    _loss_close,
    _t,
)
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import GANTrainState as JGANState, TrainState as JTrainState
from use_tpu.engine.train import make_gan_train_step
from use_tpu.models.gan import losses as jlosses
from use_tpu.models.gan.discriminators import HifiganVocoderDiscriminator24k as J24k
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu_torch.engine.convert_jax import (
    discriminator_params_to_state_dict,
    lsgan_params_to_state_dict,
)
from use_tpu_torch.engine.loop import build_gan_train_state
from use_tpu_torch.engine.train import gan_train_step
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN

BANK = "hifigan_vocoder_discriminator_24k"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bank():
    """The port's 24k bank, built once (its init draws ~60M weights)."""
    return use_tpu_torch.models.DiscriminatorRegistry.get_by_name(BANK)(seed=0)


def _first_gradients(state, params):
    """The gradient a first Adam step took, read back from its first moment:
    mu = (1 - b1)(g + wd p), b1 0.9, coupled L2 wd 1e-7 (no clip)."""
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return jax.tree.map(lambda mu, p: np.asarray(mu) / np.float32(0.1) - np.float32(1e-7) * p,
                        jax.device_get(adam.mu), params)


def _jax_d_grads_on_branches(jgan, d_params, fake, clean, masks):
    """use_tpu's D-phase gradient (jax.grad of its d_loss) with each leaky
    ReLU of D, in call order, on the branch of `masks` (the port's, NCHW /
    NCW): a pre-activation within rounding of 0 takes either branch in the
    two frameworks, and a flip moves its layer's gradient by 0.9 of a term
    (the fakes differ by ~1e-5 of their scale; a first-layer flip of the
    period-11 discriminator read 1.6 % of its weight gradient's largest)."""
    real = jax.nn.leaky_relu

    def branches(m):
        def lrelu(x, negative_slope=0.01):
            return jnp.where(next(m), x, negative_slope * x)
        return lrelu

    def grad(dp, fake, clean, masks):
        it = iter(masks)
        jax.nn.leaky_relu = branches(it)
        try:
            out = jax.grad(jgan.d_loss)(dp, {"fake": fake, "clean": clean})
        finally:
            jax.nn.leaky_relu = real
        assert next(it, None) is None  # one branch mask a leaky ReLU, in order
        return out

    return jax.jit(grad)(d_params, fake, clean,
                         [jnp.asarray(np.moveaxis(m.numpy(), 1, -1)) for m in masks])


def test_gan_train_step_with_the_24k_bank_matches_jax(bank):
    """One step of each optimizer on one microbatch: D's gradients against
    use_tpu's on the port's leaky-ReLU branches (``_jax_d_grads_on_branches``),
    G's (against use_tpu's stepped D) against the gradient use_tpu's Adam
    step took, the reported losses, and G after its Adam step (g_lr 5e-4,
    coupled L2 1e-7). D's Adam step is not compared: where a flipped branch
    moves a rounding-level gradient across 0, the first step, lr sign(g),
    moves by 2 lr (tests/test_torch_gan_train.py holds D's step)."""
    from use_tpu_torch.models.gan import discriminators as tdisc

    jgan = JLSGAN(generator=JGenerator(**GEN), discriminator=J24k(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_shape, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), CLIP))
    g_params, d_params = random_params(g_shape, seed=1), random_params(d_shape, seed=2)
    mb = _batch(10)
    rng = jax.random.PRNGKey(3)
    g_tx = joptim.adam(5e-4, 1e-7, params_example=g_params)
    d_tx = joptim.adam(2e-4, 1e-7, params_example=d_params)
    jstate = JGANState(g=JTrainState.create(g_params, g_tx), d=JTrainState.create(d_params, d_tx))
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    new, metrics = make_gan_train_step(jgan, g_tx, d_tx, accum=1, donate=False)(jstate, jb, rng)
    r = jax.random.split(rng, 1)[0]
    fake_j = jax.jit(jgan.g_forward)(g_params, jb, r)
    start = int(jax.random.randint(r, (), 0, CLIP - 496))

    gen = TGenerator(**GEN, device="cpu")
    gen.net.load_state_dict(lsgan_params_to_state_dict(g_params), strict=True)
    bank.load_state_dict(discriminator_params_to_state_dict(d_params), strict=True)
    tgan = TLSGAN(generator=gen, discriminator=bank, g_loss_cfg=dict(STEP_LOSS))
    state = build_gan_train_state(tgan, 5e-4, 2e-4, 1e-7)
    seen = {}
    for name, st in (("d", state.d), ("g", state.g)):
        real = st.apply_gradients

        def recording(name=name, st=st, real=real):
            seen[name] = {k: p.grad.clone() for k, p in st.model.named_parameters()
                          if p.grad is not None}
            real()

        st.apply_gradients = recording
    masks, real_lrelu = [], tdisc._lrelu

    def lrelu(x):
        if "d" not in seen:  # the D phase: D on the fake, then on the clean clip
            masks.append((x > 0).detach())
        return real_lrelu(x)

    tdisc._lrelu = lrelu
    try:
        out = gan_train_step(tgan, state, [_t(mb)], starts=[start])
    finally:
        tdisc._lrelu = real_lrelu
    assert set(out) == set(metrics)
    for k, v in out.items():
        _loss_close(k, v, metrics[k])
    assert len(masks) == 2 * (5 * 5 + 3 * 7 + 2)  # MPD's and MSD's, on the fake and the clean
    gd = discriminator_params_to_state_dict(jax.device_get(_jax_d_grads_on_branches(
        jgan, d_params, fake_j["fake"], fake_j["clean"], masks)))
    assert {k.split(".")[0] for k in gd} == {"MPD", "MSD", "MMD"}
    _grads_close(seen["d"], gd)
    gg = lsgan_params_to_state_dict(_first_gradients(new.g, g_params))
    _grads_close(seen["g"], gg)
    _adam_step_close(tgan.generator.net, lsgan_params_to_state_dict(jax.device_get(new.g.params)),
                     gg, 5e-4)


def test_gan24k_launch_constants_of_chip_smoke(bank):
    """chip_smoke's gan24k_train_step holds a microbatch with the 24k bank
    to GAN_TRAIN_LAUNCHES["remat"]: the bank runs none of the kernels, so a
    microbatch of the shipped generator (`ncsnpp`, remat conv_outs) counts
    as with the 24k_MVD bank."""
    import chip_smoke
    from use_tpu_torch.ops import fused_skip, gn_stats

    counts = dict(channel_sums=0, gn_apply=0, fused_skip_add=0)
    real = (gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd)

    def counting(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    gen = TGenerator(backbone="ncsnpp", n_fft=62, hop_length=16, num_frames=32, device="cpu",
                     backbone_kwargs={"remat": True, "remat_policy": "conv_outs"})
    gan = TLSGAN(generator=gen, discriminator=bank, g_loss_cfg=dict(STEP_LOSS))
    try:
        gn_stats._channel_sums_fwd = counting("channel_sums", real[0])
        gn_stats._gn_apply_fwd = counting("gn_apply", real[1])
        fused_skip._fused_skip_add_fwd = counting("fused_skip_add", real[2])
        gan_train_step(gan, build_gan_train_state(gan), [_t(_batch(30, n=1))],
                       torch.Generator().manual_seed(0))
    finally:
        gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd = real
    assert chip_smoke.all_kernels(counts) == chip_smoke.all_kernels(
        chip_smoke.GAN_TRAIN_LAUNCHES["remat"])
