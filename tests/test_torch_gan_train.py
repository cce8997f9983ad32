"""LSGAN training of use_tpu_torch against use_tpu's, on the CPU.

The G and D criteria (values and gradients), the generator's random-crop
training pass on a given crop start, one gan_train_step at accumulation 1
and 2 against use_tpu's make_gan_train_step on use_tpu's own crop draws
(D and G gradients SUMMED over the group, D stepped before G's adversarial
pass, the losses, the parameters after both Adam steps), gan_eval_step
against make_gan_eval_step, and `train experiment=LSGAN_debug device=cpu`
end to end (checkpoint of G and D, optimized_metric.json, resume, predict).
Weights move with engine/convert_jax.py; the networks are small: a
generator of 16 channels over two levels on a 62-point FFT (a 496-sample
crop), and a D of the period bank at 2 and 3 and one mel discriminator.
Tolerances (fp32; the frameworks sum in other orders, and use_tpu's DFT
is a matmul where the port's is an FFT): losses rtol 1e-5; gradients
within 1e-4 of each tensor's largest |value| plus rtol 1e-3 (readings
~1e-5). The log-magnitude term is conditioned by 1 / |X|: at near-null
bins its value and gradient follow the DFTs' rounding of |X| (a bin of
6e-6 read 5.93e-6 by one and 7.47e-6 by the other; a silent frame's
residue of the matmul against an FFT's), so its value is held to 1e-3
(readings 2.9e-5 on noise, 3.2e-4 on the speech-like clip with its
silences; the log-mel term 6.7e-5 and the sum 6.3e-5 there, the same
1e-3) and its gradient, on speech-like clips, to 1e-2 of its largest
(readings 1.4e-4 to 1.9e-3; 0.19 on a white-noise 496-sample clip, whose
2048-point frame reflects into near-nulls). The D loss is held to 1e-4,
as the mel bank in tests/test_torch_discriminators.py: its mel
discriminator's logit is a mean of a map that cancels (reading 1.9e-5);
D's gradients on a clip with digital silence are held to 1e-2 of each
tensor's largest (reading 2.1e-3: log(mel + 1e-5) of silent frames reads
the DFTs' residue), and on white noise to 1e-4. The train and eval step tests
(their subject is the engine: summing, order, the two optimizers) use the
shipped criterion without that term. The G phase runs against the
stepped D, whose first Adam step is lr sign(g): where D's gradient is
rounding-level, the sign is the framework's, so the adversarial terms of
that phase are held to 1e-4 (readings 1.6e-5) and the parameters after
the steps as `_adam_step_close` says.
"""
import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, random_params
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import GANTrainState as JGANState, TrainState as JTrainState
from use_tpu.engine.train import make_gan_eval_step, make_gan_train_step
from use_tpu.models.gan import discriminators as jdisc, losses as jlosses
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.data.synth_speech import synth_pair
from use_tpu_torch.engine.checkpoint import CheckpointManager
from use_tpu_torch.engine.convert_jax import (
    discriminator_params_to_state_dict,
    lsgan_params_to_state_dict,
)
from use_tpu_torch.engine.loop import build_gan_train_state
from use_tpu_torch.engine.train import gan_eval_step, gan_train_step
from use_tpu_torch.models.gan import discriminators as tdisc, losses as tlosses
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN

SR = 24000
GEN = dict(backbone="ncsnpp", n_fft=62, hop_length=16, num_frames=32,
           backbone_kwargs=dict(nf=16, ch_mult=(1, 2), num_res_blocks=1))
CLIP = 600  # > the 496-sample crop, so the start is drawn
SHIPPED = dict(sampling_rate=SR, alpha_wav_l1=0.1, alpha_mag_l2=1.0, alpha_mag_log=1.0,
               alpha_mag_norm_l2=0.5, alpha_mel_log=0.5, alpha_mel_l2=0.5, alpha_adv_gen=1.0,
               alpha_adv_feat=10.0)
STEP_LOSS = dict(SHIPPED, alpha_mag_log=0.0)  # the engine tests' criterion
LOG_TERMS = ("loss_G_mag_log", "loss_G_mel_log", "loss_G")  # and their sum
# D's loss (its mel logit) and the adversarial terms of a G phase, which
# runs against the stepped D (see _adam_step_close)
AFTER_D_STEP = ("loss_D", "loss_D_adv_dsc", "loss_G_adv_gen", "loss_G_adv_feat")
MAG_LOG = {**{k: 0.0 for k in SHIPPED if k.startswith("alpha")}, "alpha_mag_log": 1.0}
MEL = dict(n_fft=256, win_length=240, hop_length=60, n_mels=64)
PERIOD = dict(channels=8, max_downsample_channels=32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class JTinyD(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        per = [jdisc.PeriodDiscriminator(period=p, **PERIOD, name=f"period{p}")(x)
               for p in (2, 3)]
        lm, fm = jdisc.MelspecDiscriminator(**MEL, name="mel0")(x)
        return [[o[0] for o in per], [lm]], [[o[1] for o in per], [fm]]


class TTinyD(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.period2 = tdisc.PeriodDiscriminator(period=2, **PERIOD)
        self.period3 = tdisc.PeriodDiscriminator(period=3, **PERIOD)
        self.mel0 = tdisc.MelspecDiscriminator(**MEL)

    def forward(self, x):
        per = [self.period2(x), self.period3(x)]
        lm, fm = self.mel0(x)
        return [[o[0] for o in per], [lm]], [[o[1] for o in per], [fm]]


@pytest.fixture(scope="module")
def models():
    """use_tpu's and the port's LSGAN on one set of random G and D params."""
    jgan = JLSGAN(generator=JGenerator(**GEN), discriminator=JTinyD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_shape, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), CLIP))
    return jgan, random_params(g_shape, seed=1), random_params(d_shape, seed=2)


def _port(g_params, d_params, g_loss=STEP_LOSS):
    gen = TGenerator(**GEN, device="cpu")
    gen.net.load_state_dict(lsgan_params_to_state_dict(g_params), strict=True)
    d = TTinyD()
    d.load_state_dict(discriminator_params_to_state_dict(d_params), strict=True)
    return TLSGAN(generator=gen, discriminator=d, g_loss_cfg=dict(g_loss))


def _batch(seed, n=2, length=CLIP):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((n, length))).astype(np.float32)
    return {"clean": clean, "perturbed": (clean + 0.1 * rng.standard_normal(clean.shape))
            .astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _loss_close(name, got, want):
    tol = 1e-3 if name in LOG_TERMS else 1e-4 if name in AFTER_D_STEP else 1e-5
    assert abs(float(got) - float(want)) <= tol * abs(float(want)), name


def _grads_close(got, want, rel=1e-4):
    """Each gradient within rtol 1e-3 plus `rel` of its tensor's largest,
    plus 1e-6 of the largest of all: the attention's key bias (NIN_1.b) has
    a zero gradient in exact arithmetic, which both sides round to ~1e-9."""
    want = {k: torch.as_tensor(np.array(w)) for k, w in want.items()}
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert_close(got[k], w, rtol=1e-3, atol=rel * float(w.abs().max()) + 1e-6 * top)


def _adam_step_close(net, want, grads, lr):
    """Parameters after one Adam step against use_tpu's: within 1e-5
    relative plus 1e-7, except where the gradient is within twice the
    gradient tolerance of 0 (2e-4 of its tensor's largest, plus 1e-6 of the
    largest of all): a first Adam step is lr g / (|g| + 1e-8), lr sign(g),
    and there the sign is the frameworks' rounding; such an element may
    step the other way, by at most 2 lr."""
    grads = {k: torch.as_tensor(np.array(g)) for k, g in grads.items()}
    top = max(float(g.abs().max()) for g in grads.values())
    for k, p in net.named_parameters():
        w, g = torch.as_tensor(np.array(want[k])), grads[k]
        diff = (p.detach() - w).abs()
        sure = g.abs() > 2e-4 * float(g.abs().max()) + 1e-6 * top
        assert bool((diff[sure] <= 1e-7 + 1e-5 * w.abs()[sure]).all()), k
        assert bool((diff <= 2 * lr * (1 + 1e-5) + 1e-7 + 1e-5 * w.abs()).all()), k
        assert p.requires_grad


def test_criteria_values_and_gradients_match_jax(models):
    """On a speech-like clean clip and a noisy fake of 1984 samples:
    hifigan_g_loss (every loss_G* term, shipped weights) and its gradient
    through D into the fake, the log-magnitude term's apart;
    hifigan_d_loss and its gradient into D's params."""
    _, _, d_params = models
    clean, noisy = synth_pair(1984, 7, snr_db=5.0, sr=SR)
    c = np.stack([clean, clean[::-1]]).astype(np.float32)
    fake = np.stack([noisy, noisy[::-1]]).astype(np.float32)
    jd = JTinyD()

    def jg(cfg, f):
        b = {"clean": jnp.asarray(c), "fake": f}
        return JLSGAN(generator=JGenerator(**GEN), discriminator=jd, g_loss_cfg=cfg).g_loss(
            d_params, b)

    shipped = jlosses.HifiganGLossConfig(**SHIPPED)
    _, logs_j = jax.jit(lambda f: jg(shipped, f))(jnp.asarray(fake))
    g_j = {}
    for name, cfg in (("rest", dataclasses.replace(shipped, alpha_mag_log=0.0)),
                      ("mag_log", jlosses.HifiganGLossConfig(**MAG_LOG))):
        g_j[name] = jax.jit(jax.grad(lambda f, cfg=cfg: jg(cfg, f)[0]))(jnp.asarray(fake))
    tgan = _port(models[1], d_params, SHIPPED)
    loss, logs = tgan.g_loss({"clean": torch.from_numpy(c), "fake": torch.from_numpy(fake)})
    assert set(logs) == set(logs_j) and len(logs) == 9
    for k, v in logs.items():
        _loss_close(k, v.detach(), logs_j[k])
    for name, cfg, rel in (("rest", STEP_LOSS, 1e-4), ("mag_log", MAG_LOG, 1e-2)):
        tgan = _port(models[1], d_params, cfg)
        f = torch.from_numpy(fake).requires_grad_(True)
        tgan.g_loss({"clean": torch.from_numpy(c), "fake": f})[0].backward()
        _grads_close({"fake": f.grad}, {"fake": g_j[name]}, rel)
    # D: on this clip (digital silence at its start) and on white noise
    noise = (0.3 * np.random.default_rng(8).standard_normal((2, 2, 1984))).astype(np.float32)
    jgan = JLSGAN(generator=JGenerator(**GEN), discriminator=jd)
    d_step = jax.jit(jax.value_and_grad(lambda dp, b: jgan.d_loss(dp, b)))
    for (cl, fk), rel in (((c, fake), 1e-2), ((noise[0], noise[1]), 1e-4)):
        ld_j, gd_j = d_step(d_params, {"clean": jnp.asarray(cl), "fake": jnp.asarray(fk)})
        tgan.discriminator.zero_grad(set_to_none=True)
        ld = tgan.d_loss({"clean": torch.from_numpy(cl), "fake": torch.from_numpy(fk)})
        ld.backward()
        _loss_close("loss_D", ld.detach(), ld_j)
        got = {k: p.grad for k, p in tgan.discriminator.named_parameters()}
        _grads_close(got, discriminator_params_to_state_dict(jax.device_get(gd_j)), rel)


def test_reconstruction_gradient_is_finite_at_silence():
    """The eps inside both sqrts of the spectral convergence: at clean =
    fake = 0 the gradient is finite (and 0 where use_tpu's is)."""
    cfg_t, cfg_j = tlosses.WavSpecConvergenceConfig(), jlosses.WavSpecConvergenceConfig()
    z = np.zeros((1, 1984), np.float32)
    f = torch.zeros((1, 1984), requires_grad=True)
    sum(tlosses.wav_spec_convergence(torch.from_numpy(z), f, cfg_t).values()).backward()
    gj = jax.jit(jax.grad(lambda e: sum(jlosses.wav_spec_convergence(jnp.asarray(z), e, cfg_j)
                                        .values())))(jnp.asarray(z))
    assert torch.isfinite(f.grad).all() and np.isfinite(np.asarray(gj)).all()


@pytest.mark.parametrize("length", [CLIP, 400])
def test_forward_train_on_a_given_start_matches_jax(models, length):
    """use_tpu's crop draw replayed through `start`; a clip shorter than the
    crop is centre-padded. The fake wav within rtol 1e-4, atol 1e-5 x max
    (the NCSN++ parity tolerance)."""
    jgan, g_params, d_params = models
    b = _batch(5, length=length)
    rng = jax.random.PRNGKey(6)
    want = jgan.generator.forward_train(g_params, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    start = int(jax.random.randint(rng, (), 0, max(length - 496, 1)))
    got = _port(g_params, d_params).g_forward(_t(b), start=start)
    for k in ("clean", "perturbed", "fake"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape == (2, 496)
        assert_close(got[k].detach(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))
    drawn = TGenerator(**GEN, device="cpu").draw_start(CLIP, torch.Generator().manual_seed(0))
    assert 0 <= drawn < CLIP - 496


@pytest.fixture(scope="module")
def jax_micro_grads(models):
    """use_tpu's D and G gradients of one microbatch (D's on the detached
    fake, G's against the stepped D `new_dp`), one compile for every
    microbatch of every case."""
    jgan = models[0]

    @jax.jit
    def grads(gp, dp, new_dp, mb, r):
        fake = jax.lax.stop_gradient(jgan.g_forward(gp, mb, r))
        return (jax.grad(jgan.d_loss)(dp, fake),
                jax.grad(lambda p: jgan.g_loss(new_dp, jgan.g_forward(p, mb, r))[0])(gp))

    return grads


@pytest.mark.parametrize("accum", [1, 2])
def test_gan_train_step_matches_jax(models, jax_micro_grads, accum):
    """One step of each optimizer over `accum` microbatches on use_tpu's crop
    draws (split(rng, accum); split(rng, 1) at 1): the gradients D and G
    apply are the SUMS of the microbatches' (use_tpu's, computed here from
    its g_forward / d_loss / g_loss, G's against use_tpu's stepped D), the
    reported loss_D the group mean and loss_G* the last microbatch's, and
    G and D after their Adam steps (g_lr 5e-4, d_lr 2e-4, coupled L2 1e-7)."""
    jgan, g_params, d_params = models
    micro = [_batch(10 + i) for i in range(accum)]
    rng = jax.random.PRNGKey(3)
    g_tx = joptim.adam(5e-4, 1e-7, params_example=g_params)
    d_tx = joptim.adam(2e-4, 1e-7, params_example=d_params)
    jstate = JGANState(g=JTrainState.create(g_params, g_tx), d=JTrainState.create(d_params, d_tx))
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
    if accum == 1:
        stacked = {k: v[0] for k, v in stacked.items()}
    new, metrics = make_gan_train_step(jgan, g_tx, d_tx, accum=accum, donate=False)(
        jstate, stacked, rng)
    rngs = list(jax.random.split(rng, max(accum, 1)))
    jb = [{k: jnp.asarray(v) for k, v in m.items()} for m in micro]
    gd_j = jax.tree.map(jnp.zeros_like, d_params)
    gg_j = jax.tree.map(jnp.zeros_like, g_params)
    for mb, r in zip(jb, rngs):
        gd, gg = jax_micro_grads(g_params, d_params, new.d.params, mb, r)
        gd_j, gg_j = jax.tree.map(jnp.add, gd_j, gd), jax.tree.map(jnp.add, gg_j, gg)
    starts = [int(jax.random.randint(r, (), 0, CLIP - 496)) for r in rngs]

    tgan = _port(g_params, d_params)
    state = build_gan_train_state(tgan, 5e-4, 2e-4, 1e-7)
    seen = {}
    for name, st in (("d", state.d), ("g", state.g)):
        real = st.apply_gradients

        def recording(name=name, st=st, real=real):
            seen[name] = {k: p.grad.clone() for k, p in st.model.named_parameters()
                          if p.grad is not None}
            real()

        st.apply_gradients = recording
    out = gan_train_step(tgan, state, [_t(m) for m in micro], starts=starts)
    assert state.g.step == state.d.step == 1
    assert set(out) == set(metrics)
    for k, v in out.items():
        _loss_close(k, v, metrics[k])
    _grads_close(seen["d"], discriminator_params_to_state_dict(jax.device_get(gd_j)))
    _grads_close(seen["g"], lsgan_params_to_state_dict(jax.device_get(gg_j)))
    _adam_step_close(tgan.discriminator,
                     discriminator_params_to_state_dict(jax.device_get(new.d.params)),
                     discriminator_params_to_state_dict(jax.device_get(gd_j)), 2e-4)
    _adam_step_close(tgan.generator.net, lsgan_params_to_state_dict(jax.device_get(new.g.params)),
                     lsgan_params_to_state_dict(jax.device_get(gg_j)), 5e-4)


def test_gan_eval_step_matches_jax(models):
    """The inference pass (frames padded to 64, no crop) and every loss_G*
    against the current D, at an odd length."""
    jgan, g_params, d_params = models
    b = _batch(20, length=1001)
    jstate = JGANState(g=JTrainState.create(g_params, joptim.adam()),
                       d=JTrainState.create(d_params, joptim.adam()))
    want = make_gan_eval_step(jgan)(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    got = gan_eval_step(_port(g_params, d_params), _t(b))
    assert set(got) == set(want) and len(got) == 9
    for k, v in got.items():
        _loss_close(k, v, want[k])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train experiment=LSGAN_debug device=cpu` for one epoch on two
    synth_speech clips; -> (root, data overrides, out_dir, summary)."""
    root = tmp_path_factory.mktemp("gan")
    jl = root / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(2):
            clean, _ = synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(root / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    data = [f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
            "data.reverb_use_FRA=true", "data.min_duration_seconds=0.1",
            "data.speech_splice_seconds=1", "data.num_workers=0"]
    out = str(root / "run")
    summary = main(["train", "experiment=LSGAN_debug", *data, "train.max_epochs=1",
                    f"out_dir={out}", "device=cpu"])
    return root, data, out, summary


def test_cli_train_lsgan_writes_checkpoints_of_g_and_d(trained):
    _, _, out, summary = trained
    # 2 clips in a batch of 2, accumulation 1: one optimizer step of each network
    assert summary["optimizer_steps"] == 1 and summary["clips"] == 2
    row = summary["history"][0]
    assert np.isfinite(row["train/loss_G"]) and np.isfinite(row["train/loss_D"])
    assert {"val/loss_G", "val/loss_G_adv_feat", "lr/G", "lr/D"} <= set(row)
    state = CheckpointManager(os.path.join(out, "checkpoints")).restore(0)
    assert set(state) == {"g", "d"} and state["g"]["step"] == state["d"]["step"] == 1
    assert any(k.startswith("MPD.period2.") for k in state["d"]["model"])
    with open(os.path.join(out, "optimized_metric.json")) as f:
        rec = json.load(f)
    assert rec["metric"] == "val/loss_G" and np.isfinite(rec["value"])
    assert np.isfinite(rec["test"]["test/loss_G"]) and "test/loss_G_mel_l2" in rec["test"]


def test_cli_train_lsgan_resumes_and_predicts_from_its_checkpoint(trained):
    """A second run with ckpt_path= trains epoch 1 only, from epoch 0's G, D
    and optimizer states; predict serves the trained generator."""
    root, data, out, _ = trained
    summary = main(["train", "experiment=LSGAN_debug", *data, "train.max_epochs=2",
                    f"ckpt_path={out}/checkpoints", f"out_dir={out}", "device=cpu"])
    assert [h["epoch"] for h in summary["history"]] == [1]
    state = CheckpointManager(os.path.join(out, "checkpoints")).restore(1)
    assert state["g"]["step"] == state["d"]["step"] == 2
    write_wav(str(root / "in" / "a.wav"),
              (0.1 * np.random.default_rng(0).standard_normal(3001)).astype(np.float32), SR)
    pred = main(["predict", "experiment=LSGAN_debug", f"ckpt_path={out}/checkpoints",
                 f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / 'out'}",
                 "device=cpu"])
    assert pred["files"] == 1
    wav, sr = read_wav(str(root / "out" / "a.wav"))
    assert sr == SR and wav.shape == (3001,) and np.isfinite(wav).all()


def test_gan_launch_constants_of_chip_smoke():
    """chip_smoke's GAN_TRAIN_LAUNCHES: each kernel's calls in one LSGAN
    microbatch of the shipped generator (`ncsnpp`, 45 GroupNorms and 15
    shortcuts a forward), counted here on a small input: the D phase's
    forward, the G phase's and, under remat, the 40 GroupNorms and 15
    shortcuts inside residual blocks again; and an eval batch's 45 / 45 /
    15 (PER_GENERATOR_FORWARD)."""
    import chip_smoke
    from use_tpu_torch.ops import fused_skip, gn_stats

    counts = {}
    real = (gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd)

    def counting(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    got = {}
    d = TTinyD()
    mb = _t(_batch(30, n=1))
    try:
        gn_stats._channel_sums_fwd = counting("channel_sums", real[0])
        gn_stats._gn_apply_fwd = counting("gn_apply", real[1])
        fused_skip._fused_skip_add_fwd = counting("fused_skip_add", real[2])
        for remat in (True, False):
            gen = TGenerator(backbone="ncsnpp", n_fft=62, hop_length=16, num_frames=32,
                             device="cpu", backbone_kwargs={"remat": remat,
                                                            "remat_policy": "conv_outs"})
            gan = TLSGAN(generator=gen, discriminator=d, g_loss_cfg=dict(STEP_LOSS))
            counts.update(channel_sums=0, gn_apply=0, fused_skip_add=0)
            gan_train_step(gan, build_gan_train_state(gan), [mb], torch.Generator().manual_seed(0))
            got[remat] = {**counts, "qconv3x3_fused": 0}
        counts.update(channel_sums=0, gn_apply=0, fused_skip_add=0)
        gan_eval_step(gan, mb)
        got["eval"] = {**counts, "qconv3x3_fused": 0}
    finally:
        gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd = real
    assert got[True] == chip_smoke.GAN_TRAIN_LAUNCHES["remat"] == {
        "channel_sums": 130, "gn_apply": 130, "fused_skip_add": 45, "qconv3x3_fused": 0}
    assert got[False] == chip_smoke.GAN_TRAIN_LAUNCHES["no_remat"] == {
        "channel_sums": 90, "gn_apply": 90, "fused_skip_add": 30, "qconv3x3_fused": 0}
    assert got["eval"] == chip_smoke.PER_GENERATOR_FORWARD
