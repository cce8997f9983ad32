"""CSMGAN, the causal streaming generator, of use_tpu_torch against use_tpu's,
on the CPU.

At use_tpu's tiny test configuration (n_fft 96, hop 48, input_freq 48,
channels (4, 4, 8), TCN 32 x 2 layers; tests/test_csmgan.py:75-80), with
weights drawn with numpy and moved by engine/convert_jax.py::
csmgan_params_to_state_dict: each module offline and streamed, the
wrapper's offline forward, the stream against the port's own offline pass
and against use_tpu's CSMGANStream, enhance_streaming's session reuse and
its errors, the converter's round trip through use_tpu's
convert_csmgan_state_dict, and gan_train_step against make_gan_train_step
(the CLI: tests/test_torch_csmgan_cli.py).

Tolerances (fp32; the frameworks sum convolutions and cumulative sums in
other orders, and use_tpu's DFT is a matmul where the port's is an FFT):
module outputs within 1e-5 of their largest |value| plus rtol 1e-4; wavs
within 1e-5 of their largest plus rtol 1e-4 (readings about 1e-6 of the
largest). The cumulative norms compute the variance as E[x^2] - E[x]^2 with
an eps of 1e-8 (1-D) and 1e-6 (2-D): where a frame has almost no variance,
rsqrt(var + eps) multiplies any difference of summation order by up to
1e4 (1-D) or 1e3 (2-D). Such frames are exact where the input is digitally
silent from the start (x - mean = 0 exactly, on either side), and the
inputs here hold silent stretches at the start and inside, so that the
conditioning is exercised and still held to the same bound. The stream
against the port's own offline pass is the same arithmetic in other shapes:
it is held to the same bound.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, random_params
from tests.test_torch_gan_train import PERIOD, STEP_LOSS, _grads_close, _loss_close
from use_tpu.engine import optim as joptim
from use_tpu.engine.convert_torch import convert_csmgan_state_dict
from use_tpu.engine.state import GANTrainState as JGANState, TrainState as JTrainState
from use_tpu.engine.train import make_gan_train_step
from use_tpu.models.gan import csmgan as jc
from use_tpu.models.gan import discriminators as jdisc, losses as jlosses
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu_torch.engine.convert_jax import (
    csmgan_params_to_state_dict,
    discriminator_params_to_state_dict,
)
from use_tpu_torch.engine.loop import build_gan_train_state
from use_tpu_torch.engine.train import gan_train_step
from use_tpu_torch.models.gan import csmgan as tc
from use_tpu_torch.models.gan import discriminators as tdisc
from use_tpu_torch.models.gan.lsgan import LSGAN as TLSGAN

SR = 24000
HOP = 48
TINY = dict(n_fft=96, win_length=96, hop_length=HOP, input_freq=48,
            encoder_channels=(4, 4, 8), encoder_depths=(1, 1), decoder_depths=(1, 1),
            tcn_input_dim=96, tcn_bn_dim=32, tcn_hidden_dim=32, tcn_layers=2, tcn_stacks=1,
            in_proj_channels=4)
CLI_TINY = [f"model.generator.{k}={list(v) if isinstance(v, tuple) else v}".replace(" ", "")
            for k, v in TINY.items()]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert_close(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def _convert(params, scope, strip):
    """A module's use_tpu params, placed at `scope` of a CSMGAN tree,
    through csmgan_params_to_state_dict, with `strip` cut from the keys."""
    tree = params
    for name in reversed(scope):
        tree = {name: tree}
    sd = csmgan_params_to_state_dict(tree)
    assert all(k.startswith(strip) for k in sd), sorted(sd)
    return {k[len(strip):]: v for k, v in sd.items()}


# name: (use_tpu module(stream), port module, scope, stripped prefix, input shape
# in use_tpu's layout [B, T, F, C] or [B, T, C])
MODULES = {
    "CumLN1d": (lambda s: jc.CumLN1d(stream=s), lambda: tc.CumLN1d(6),
                ("bottleneck", "CumLN1d_0"), "bottleneck.LN.", (2, 10, 6)),
    "CumLN2d": (lambda s: jc.CumLN2d(stream=s), lambda: tc.CumLN2d(6),
                ("enc0_glfb0", "CumLN2d_0"), "encoder.0.glfb.0.first_block.0.", (2, 10, 5, 6)),
    "CausalConv2d": (lambda s: jc.CausalConv2d(6, (3, 3), dilation=(2, 1), groups=2, stream=s),
                     lambda: tc.CausalConv2d(4, 6, (3, 3), dilation=(2, 1), groups=2),
                     ("in_proj",), "in_proj.", (2, 10, 5, 4)),
    "SeChannelModule": (lambda s: jc.SeChannelModule(4, stream=s), lambda: tc.SeChannelModule(4),
                        ("enc0_glfb0", "SeChannelModule_0"),
                        "encoder.0.glfb.0.first_block.4.", (2, 10, 5, 4)),
    "SeFreqModule": (lambda s: jc.SeFreqModule(5), lambda: tc.SeFreqModule(5),
                     ("enc0_glfb0", "SeFreqModule_0"),
                     "encoder.0.glfb.0.first_block.5.", (2, 10, 5, 4)),
    "GLFB": (lambda s: jc.GLFB(4, dilation=(2, 1), freq_dim=5, stream=s),
             lambda: tc.GLFB(4, dilation=(2, 1), freq_dim=5),
             ("enc0_glfb0",), "encoder.0.glfb.0.", (2, 10, 5, 4)),
    "GLFB_IN": (lambda s: jc.GLFB(4, norm="IN", freq_dim=5), lambda: tc.GLFB(4, norm="IN", freq_dim=5),
                ("enc0_glfb0",), "encoder.0.glfb.0.", (2, 10, 5, 4)),
    "DepthConv1d": (lambda s: jc.DepthConv1d(8, 16, 3, dilation=2, stream=s),
                    lambda: tc.DepthConv1d(8, 16, 3, dilation=2),
                    ("bottleneck", "DepthConv1d_0"), "bottleneck.TCN.0.", (2, 10, 8)),
    "TCN": (lambda s: jc.TCN(24, 24, 8, 16, layer=2, stack=2, stream=s),
            lambda: tc.TCN(24, 24, 8, 16, layer=2, stack=2),
            ("bottleneck",), "bottleneck.", (2, 10, 24)),
    "PixelShuffleBlock": (lambda s: jc.PixelShuffleBlock(3, stream=s),
                          lambda: tc.PixelShuffleBlock(4, 3),
                          ("up0",), "decoder.0.deconv.", (2, 10, 5, 4)),
}
STREAMS = {"CumLN1d", "CumLN2d", "CausalConv2d", "SeChannelModule", "GLFB", "DepthConv1d", "TCN",
           "PixelShuffleBlock"}


def _to_torch_layout(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _from_torch_layout(y):
    y = y[0] if isinstance(y, tuple) else y
    return np.moveaxis(y.detach().numpy(), 1, -1)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_offline_and_streamed_matches_jax(name):
    """Offline against use_tpu's module; streamed (chunks of 3, 3, 3, 1
    frames, the state carried) against use_tpu's streamed module and the
    port's own offline pass. Frames 0-1 and 5 of batch 1 are silent."""
    jmod, tmod, scope, strip, shape = MODULES[name]
    rng = np.random.default_rng(sorted(MODULES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    x[1, :2] = 0.0
    x[1, 5] = 0.0
    params = random_params(jax.eval_shape(jmod(False).init, jax.random.PRNGKey(0),
                                          jnp.asarray(x))["params"], seed=7)
    want = jax.jit(jmod(False).apply)({"params": params}, jnp.asarray(x))
    want = want[0] if isinstance(want, tuple) else want
    mod = tmod()
    mod.load_state_dict(_convert(params, scope, strip), strict=True)
    with torch.no_grad():
        got = _from_torch_layout(mod(_to_torch_layout(x)))
    _close(got, want)
    if name not in STREAMS:
        return
    jstream = jax.jit(functools.partial(jmod(True).apply, mutable=["stream"]))
    variables, jparts, tparts, state = {"params": params}, [], [], {}
    with torch.no_grad():
        for lo, hi in ((0, 3), (3, 6), (6, 9), (9, 10)):
            out, mut = jstream(variables, jnp.asarray(x[:, lo:hi]))
            variables = {"params": params, **mut}
            jparts.append(np.asarray(out[0] if isinstance(out, tuple) else out))
            with tc.streaming(tc.causal_modules(mod), state):
                tparts.append(_from_torch_layout(mod(_to_torch_layout(x[:, lo:hi]))))
    assert state  # the stream state was carried
    _close(np.concatenate(tparts, 1), np.concatenate(jparts, 1))
    _close(np.concatenate(tparts, 1), got)


@pytest.fixture(scope="module")
def nets():
    """use_tpu's tiny wrapper and random params, and the port's on them."""
    jw = jc.CSMGANWrapper(**TINY)
    params = random_params(jax.eval_shape(jw.init_params, jax.random.PRNGKey(0)), seed=3)
    tw = tc.CSMGANWrapper(**TINY, device="cpu")
    tw.net.load_state_dict(csmgan_params_to_state_dict(params), strict=True)
    return jw, params, tw


def _jax_offline(jw, params, wav):
    return jax.jit(lambda p, w: jw(p, {"perturbed": w})["fake"])(params, jnp.asarray(wav))


def _clip(seed, length, batch=1, silent=False):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((batch, length))).astype(np.float32)
    if silent:  # digital silence at the start and a stretch inside
        wav[:, :150] = 0.0
        wav[:, length // 2 : length // 2 + 300] = 0.0
    return wav


def test_params_round_trip_through_use_tpu_convert_torch(nets):
    """use_tpu params -> the port's state_dict (the reference's keys) ->
    use_tpu's convert_csmgan_state_dict -> the same params, bit for bit;
    at the shipped width the port holds the reference's 14,865,275."""
    _, params, tw = nets
    sd = csmgan_params_to_state_dict(params)
    assert set(sd) == set(tw.net.state_dict())
    back = convert_csmgan_state_dict(sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == set(flat_back)
    for path, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(arr))
    full = tc.CSMGAN()
    assert sum(p.numel() for p in full.parameters()) == 14_865_275
    assert {"in_proj.conv.weight", "encoder.1.glfb.0.first_block.4.conv.conv.weight",
            "bottleneck.TCN.11.dconv1d.weight", "decoder.3.deconv.conv.conv.weight",
            "out_proj.conv.bias"} <= set(full.state_dict())


@pytest.mark.parametrize("silent", [False, True])
def test_wrapper_forward_matches_jax(nets, silent):
    """Batch 2 at 1001 samples (not hop-aligned)."""
    jw, params, tw = nets
    wav = _clip(1, 1001, batch=2, silent=silent)
    want = _jax_offline(jw, params, wav)
    got = tw.forward_infer({"perturbed": torch.from_numpy(wav)})
    assert set(got) >= {"perturbed", "perturbed_spectra", "fake_spectra", "fake"}
    _close(got["fake"], want)


@pytest.mark.parametrize("case", ["plain", "sqrt", "silent"])
def test_stream_matches_offline_and_jax(nets, case):
    """CSMGANStream at chunk_frames 2 over a hop-aligned clip (5 chunks and
    the flush): against the port's offline forward of the clip and against
    use_tpu's CSMGANStream; 'sqrt' runs the compression branch on both
    sides of the network, 'silent' a clip with silent stretches."""
    jw, params, tw = nets
    if case == "sqrt":
        jw = jc.CSMGANWrapper(**TINY, compression="sqrt")
        tw = tc.CSMGANWrapper(**TINY, compression="sqrt", device="cpu")
        tw.net.load_state_dict(csmgan_params_to_state_dict(params), strict=True)
    k, n = 2, 5
    wav = _clip(2, n * k * HOP, silent=case == "silent")
    offline = tw.forward_infer({"perturbed": torch.from_numpy(wav)})["fake"]
    sess = tc.CSMGANStream(tw, batch_size=1, chunk_frames=k)
    jsess = jc.CSMGANStream(jw, params, batch_size=1, chunk_frames=k)
    parts, jparts = [], []
    for i in range(n):
        chunk = wav[:, i * k * HOP : (i + 1) * k * HOP]
        parts.append(sess.step(torch.from_numpy(chunk)))
        jparts.append(np.asarray(jsess.step(jnp.asarray(chunk))))
        assert parts[-1].shape[1] == (k - 1 if i == 0 else k) * HOP
    parts.append(sess.flush())
    jparts.append(np.asarray(jsess.flush()))
    stream = torch.cat(parts, dim=1)
    _close(stream, offline)
    _close(stream, np.concatenate(jparts, axis=1))


def test_enhance_streaming_pads_reuses_and_matches_jax(nets):
    """A clip that is not hop-aligned (5 hops + 17), padded to whole chunks
    of 2 frames and cut back: against the port's offline pass of the padded
    clip and use_tpu's enhance_streaming; a second call with the session
    reuses it (reset) and gives the same output; other weights, batch or
    chunk_frames make a new one."""
    jw, params, tw = nets
    length = 5 * HOP + 17
    wav = _clip(4, length, silent=True)
    padded = np.pad(wav, ((0, 0), (0, (-length) % (2 * HOP))))
    offline = tw.forward_infer({"perturbed": torch.from_numpy(padded)})["fake"][:, :length]
    out, sess = tw.enhance_streaming(torch.from_numpy(wav), chunk_frames=2)
    assert out.shape == (1, length)
    _close(out, offline)
    _close(out, jw.enhance_streaming(params, jnp.asarray(wav), chunk_frames=2)[0])
    again, sess2 = tw.enhance_streaming(wav, chunk_frames=2, session=sess)
    assert sess2 is sess
    assert torch.equal(again, out)
    assert tw.enhance_streaming(np.concatenate([wav, wav]), chunk_frames=2,
                                session=sess)[1] is not sess
    assert tw.enhance_streaming(wav, chunk_frames=3, session=sess)[1] is not sess
    with torch.no_grad():
        tw.net.out_proj.conv.bias.add_(1.0)
    try:
        other, sess3 = tw.enhance_streaming(wav, chunk_frames=2, session=sess)
        assert sess3 is not sess and not torch.equal(other, out)
    finally:
        with torch.no_grad():
            tw.net.out_proj.conv.bias.sub_(1.0)
    assert tw.enhance_streaming(wav, chunk_frames=2, session=sess2)[1] is not sess2


def test_stream_refuses_what_use_tpu_refuses(nets):
    _, _, tw = nets
    with pytest.raises(ValueError, match="chunk_frames must be >= 2"):
        tc.CSMGANStream(tw, chunk_frames=1)
    bad = tc.CSMGANWrapper(**{**TINY, "win_length": 80}, device="cpu")
    with pytest.raises(NotImplementedError, match="win_length == n_fft == 2\\*hop"):
        tc.CSMGANStream(bad)
    bad = tc.CSMGANWrapper(**{**TINY, "n_fft": 128, "input_freq": 64, "win_length": 128,
                              "tcn_input_dim": 128}, device="cpu")
    with pytest.raises(NotImplementedError, match="win_length == n_fft == 2\\*hop"):
        tc.CSMGANStream(bad)
    with pytest.raises(NotImplementedError, match="norm='CLN', got IN"):
        tc.CSMGANStream(tc.CSMGANWrapper(**TINY, glfb_norm="IN", device="cpu"))
    with pytest.raises(NotImplementedError, match="norm='CLN', got BN"):
        tc.require_streamable("BN")
    with pytest.raises(NotImplementedError, match="Unsupported normalization"):
        tc.get_norm("LN", 4)
    sess = tc.CSMGANStream(tw, chunk_frames=2)
    with pytest.raises(RuntimeError, match="before any step"):
        sess.flush()
    with pytest.raises(ValueError, match="chunk of shape"):
        sess.step(torch.zeros(1, 3 * HOP))
    sess.step(torch.zeros(1, 2 * HOP))
    sess.flush()
    with pytest.raises(RuntimeError, match="already flushed"):
        sess.step(torch.zeros(1, 2 * HOP))
    with pytest.raises(RuntimeError, match="already flushed"):
        sess.flush()


@pytest.mark.parametrize("silent", [2 * HOP, 100 * HOP])
def test_gradients_finite_at_digital_silence(silent):
    """At the shipped TCN depth (6 layers x 2 stacks, here narrow) and the
    port's seeded init, a clip whose first 40 ms, or all of it, is
    digitally silent: finite gradients. With zero conv biases (use_tpu's
    Flax init) silent frames stay exactly 0 through every conv, the
    cumulative norms see a variance of 0, and their backward overflows
    (CSMGAN's docstring)."""
    from use_tpu_torch.data.synth_speech import synth_pair

    tw = tc.CSMGANWrapper(**{**TINY, "tcn_layers": 6, "tcn_stacks": 2}, device="cpu", seed=2)
    clean, noisy = (torch.from_numpy(a[None].astype(np.float32))
                    for a in synth_pair(100 * HOP, 3, snr_db=5.0, sr=SR))
    noisy[:, :silent] = 0.0
    out = tw.forward({"perturbed": noisy})["fake"]
    (out - clean).abs().mean().backward()
    assert torch.isfinite(out).all()
    for name, p in tw.net.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


class JPeriodD(fnn.Module):
    """The D of these tests: the period discriminators at 2 and 3."""

    @fnn.compact
    def __call__(self, x):
        per = [jdisc.PeriodDiscriminator(period=p, **PERIOD, name=f"period{p}")(x)
               for p in (2, 3)]
        return [[o[0] for o in per]], [[o[1] for o in per]]


class TPeriodD(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.period2 = tdisc.PeriodDiscriminator(period=2, **PERIOD)
        self.period3 = tdisc.PeriodDiscriminator(period=3, **PERIOD)

    def forward(self, x):
        per = [self.period2(x), self.period3(x)]
        return [[o[0] for o in per]], [[o[1] for o in per]]


def test_gan_train_step_matches_jax(nets):
    """One step of each optimizer on one microbatch of two whole clips (the
    forward is crop-free on both sides): the D and G gradients
    gan_train_step applies against use_tpu's (D's from the fake without
    autograd, G's against the D make_gan_train_step stepped), and the
    losses against make_gan_train_step's metrics, with the tolerances
    tests/test_torch_gan_train.py argues for the LSGAN generator's. The
    last TCN block's res_out reaches no output (the TCN sums the skips):
    use_tpu's gradient there is exactly 0, where autograd leaves None."""
    jw, g_params, tw = nets
    jgan = JLSGAN(generator=jw, discriminator=JPeriodD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    _, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), 2400))
    d_params = random_params(d_shape, seed=2)
    rng = np.random.default_rng(10)
    clean = (0.3 * rng.standard_normal((2, 2400))).astype(np.float32)
    mb = {"clean": clean, "perturbed": (clean + 0.1 * rng.standard_normal(clean.shape))
          .astype(np.float32)}
    g_tx = joptim.adam(5e-4, 1e-7, params_example=g_params)
    d_tx = joptim.adam(2e-4, 1e-7, params_example=d_params)
    jstate = JGANState(g=JTrainState.create(g_params, g_tx), d=JTrainState.create(d_params, d_tx))
    step = make_gan_train_step(jgan, g_tx, d_tx, accum=1, donate=False)

    @jax.jit
    def run(state, b):  # the step and the gradients it applied, in one compile
        new, metrics = step(state, b, jax.random.PRNGKey(3))
        gp, dp = state.g.params, state.d.params
        fake = jax.lax.stop_gradient(jgan.g_forward(gp, b, None))
        gd = jax.grad(jgan.d_loss)(dp, fake)
        gg = jax.grad(lambda p: jgan.g_loss(new.d.params, jgan.g_forward(p, b, None))[0])(gp)
        return metrics, gd, gg

    metrics, gd_j, gg_j = run(jstate, {k: jnp.asarray(v) for k, v in mb.items()})
    d = TPeriodD()
    d.load_state_dict(discriminator_params_to_state_dict(d_params), strict=True)
    tgan = TLSGAN(generator=tw, discriminator=d, g_loss_cfg=dict(STEP_LOSS))
    before = {k: p.detach().clone() for k, p in tw.net.named_parameters()}
    state = build_gan_train_state(tgan, 5e-4, 2e-4, 1e-7)
    seen = {}
    for name, st in (("d", state.d), ("g", state.g)):
        real = st.apply_gradients

        def recording(name=name, st=st, real=real):
            seen[name] = {k: p.grad.clone() for k, p in st.model.named_parameters()
                          if p.grad is not None}
            real()

        st.apply_gradients = recording
    try:
        out = gan_train_step(tgan, state, [{k: torch.from_numpy(v) for k, v in mb.items()}])
    finally:
        with torch.no_grad():
            for k, p in tw.net.named_parameters():
                p.copy_(before[k])
    assert state.g.step == state.d.step == 1
    assert set(out) == set(metrics)
    for k, v in out.items():
        _loss_close(k, v, metrics[k])
    _grads_close(seen["d"], discriminator_params_to_state_dict(jax.device_get(gd_j)))
    want_g = csmgan_params_to_state_dict(jax.device_get(gg_j))
    unused = sorted(set(want_g) - set(seen["g"]))
    assert unused == ["bottleneck.TCN.1.res_out.bias", "bottleneck.TCN.1.res_out.weight"]
    for k in unused:
        assert not want_g[k].any()
        seen["g"][k] = torch.zeros_like(want_g[k])
    _grads_close(seen["g"], want_g)
