"""Training parity: use_tpu_torch's kernel gradients, train loss, train step
and optimizer against use_tpu's, on the CPU.

The kernel wrappers' autograd Functions run here with their plain forward
and their explicit backward (on the card the forward is the kernel and the
backward the same torch ops). Inputs are drawn with numpy and handed to
both packages; the train loss takes use_tpu's own draws (crop, t, z from
`jax.random.split(rng, 3)`) injected into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, nchw_to_nhwc, nhwc_to_nchw, random_params
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import TrainState as JTrainState
from use_tpu.engine.train import _accum_grads
from use_tpu.models.ncsnpp.layers import GroupNormAct as JGroupNormAct
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu.models.sgmse.sdes import crandn as jcrandn
from use_tpu.ops import gn_stats as jgn
from use_tpu.ops.pallas_skip import reference_skip_add
from use_tpu_torch.engine import optim as toptim
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.engine.state import TrainState
from use_tpu_torch.engine.train import sgmse_train_step
from use_tpu_torch.models.ncsnpp import layers as tlayers
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel
from use_tpu_torch.ops import fused_qconv, fused_skip, gn_stats

# SGMSE_debug's model (ncsnpp6M, n_fft 254, hop 64, 32 frames) with its
# backbone_kwargs from SGMSE_Large (remat, conv_outs)
DEBUG = dict(backbone="ncsnpp6M", sde="ouve", t_eps=0.03, condition="noisy",
             sde_input="noisy", loss_type="mse", n_fft=254, hop_length=64, num_frames=32)
CLIP_LEN = 2400  # > the 1984-sample crop, so the crop start is drawn
# a smaller net for the step and optimizer tests (their subject is the
# engine, not the backbone): 16 channels, 62-point FFT, a 496-sample crop
TINY = dict(DEBUG, backbone="ncsnpp", n_fft=62, hop_length=16)
TINY_KWARGS = {"nf": 16, "ch_mult": (1, 2), "remat": True, "remat_policy": "conv_outs"}
TINY_LEN = 600


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once; torch's pool of every core in
    each oversubscribes the machine and slows its ops many times over, so
    this module's torch work runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



# -- kernel Functions ------------------------------------------------------

def test_channel_sums_backward_matches_jax_vjp():
    """dx = ds + 2 x dss, use_tpu's custom VJP, in the port's [B, C, S]
    layout; the same fp32 arithmetic: 1e-6 relative."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)  # use_tpu [B, S, C]
    ds, dss = (rng.standard_normal((2, 12)).astype(np.float32) for _ in range(2))
    (s_j, ss_j), vjp = jax.vjp(jgn.channel_sums, jnp.asarray(x))
    (dx_j,) = vjp((jnp.asarray(ds), jnp.asarray(dss)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).requires_grad_()
    s_t, ss_t = gn_stats.channel_sums(xt)
    assert s_t.grad_fn is not None
    torch.autograd.backward((s_t, ss_t), (torch.from_numpy(ds), torch.from_numpy(dss)))
    assert_close(s_t.detach(), s_j, rtol=1e-6, atol=1e-5)
    assert_close(ss_t.detach(), ss_j, rtol=1e-6, atol=1e-5)
    assert_close(xt.grad.numpy().transpose(0, 2, 1), dx_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["swish", None])
def test_group_norm_act_grads_match_jax(act):
    """Gradients of sum(dy * GroupNormAct(x)) for x, weight and bias: the
    port's two Functions (statistics, apply) against jax.grad through
    use_tpu's GroupNormAct, and torch's own group_norm autograd as a second
    witness. fp32 sums in other orders: rtol 1e-4, atol 1e-5 x max|g|."""
    c = 32
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6, 10, c)) + 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jact = jax.nn.silu if act == "swish" else None
    mod = JGroupNormAct(c, act=jact)

    def jloss(x, w, b):
        return jnp.sum(mod.apply({"params": {"scale": w, "bias": b}}, x) * dy)

    gx_j, gw_j, gb_j = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), w, b)

    tmod = tlayers.GroupNormAct(c, act=act)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w))
        tmod.bias.copy_(torch.from_numpy(b))
    xt = nhwc_to_nchw(x).requires_grad_()
    dyt = nhwc_to_nchw(dy)
    (tmod(xt) * dyt).sum().backward()
    wit_x = nhwc_to_nchw(x).requires_grad_()
    wit_w = torch.from_numpy(w).requires_grad_()
    wit_b = torch.from_numpy(b).requires_grad_()
    y = F.group_norm(wit_x, gn_stats.num_groups(c), wit_w, wit_b, 1e-6)
    ((F.silu(y) if act else y) * dyt).sum().backward()
    for got, want, wit in ((nchw_to_nhwc(xt.grad), gx_j, nchw_to_nhwc(wit_x.grad)),
                           (tmod.weight.grad, gw_j, wit_w.grad), (tmod.bias.grad, gb_j, wit_b.grad)):
        top = float(np.abs(np.asarray(want)).max())
        assert_close(got, want, rtol=1e-4, atol=1e-5 * top)
        assert_close(got, wit, rtol=1e-4, atol=1e-5 * top)


@pytest.mark.parametrize("act", sorted(gn_stats.ACT_CODES, key=str))
def test_gn_apply_backward_every_activation(act):
    """The apply Function's explicit backward (each activation's own torch
    backward op) against autograd through gn_apply_plain, for x, the sums
    and the affine: the same fp32 math, rtol 1e-5, atol 1e-6 x max|g|."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 30)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(16)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(16)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 16, 30)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(leaves[0], *gn_stats.channel_sums(leaves[0]), leaves[1], leaves[2], 4, 1e-6, act)
        return torch.autograd.grad(y, leaves, dy)

    for got, want in zip(grads(gn_stats.gn_apply), grads(gn_stats.gn_apply_plain)):
        assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("shape", [(2, 12, 8, 5, 7), (1, 8, 16, 4, 4)])  # (B, Ci, Co, H, W)
def test_fused_skip_add_grads_match_plain_and_jax(shape):
    """Gradients of sum(dy * (h + W x + b) * scale) for x, h, W and b: the
    Function's explicit backward against autograd through
    fused_skip_add_plain and jax.vjp of use_tpu's reference_skip_add; fp32
    products in other orders: rtol 1e-5, atol 1e-5 x max|g|."""
    bsz, ci, co, hh, ww = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((bsz, hh, ww, ci)).astype(np.float32)
    h = rng.standard_normal((bsz, hh, ww, co)).astype(np.float32)
    w = (rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)  # use_tpu [Ci, Co]
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    dy = rng.standard_normal((bsz, hh, ww, co)).astype(np.float32)
    scale = 2 ** -0.5
    _, vjp = jax.vjp(lambda *a: reference_skip_add(*a, scale=scale), x, h, w, b)
    gx_j, gh_j, gw_j, gb_j = vjp(jnp.asarray(dy))

    def run(fn):
        args = [nhwc_to_nchw(x).requires_grad_(), nhwc_to_nchw(h).requires_grad_(),
                torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None].requires_grad_(),
                torch.from_numpy(b).requires_grad_()]
        (fn(*args, scale) * nhwc_to_nchw(dy)).sum().backward()
        return [nchw_to_nhwc(args[0].grad), nchw_to_nhwc(args[1].grad),
                args[2].grad[:, :, 0, 0].numpy().T, args[3].grad.numpy()]

    got = run(fused_skip.fused_skip_add)
    plain = run(fused_skip.fused_skip_add_plain)
    for g, p, j in zip(got, plain, (gx_j, gh_j, gw_j, gb_j)):
        top = float(np.abs(np.asarray(j)).max())
        assert_close(g, p, rtol=1e-5, atol=1e-5 * top)
        assert_close(g, j, rtol=1e-5, atol=1e-5 * top)


def test_serving_kernels_raise_under_autograd():
    """gn_fold and K3 have no gradient: with grad mode on and an input that
    requires one they raise, and never hand back a detached result."""
    x = torch.randn(2, 8, 16)
    w = torch.ones(8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        gn_stats.gn_fold(x, w, b, 2)
    with torch.no_grad():
        a, off = gn_stats.gn_fold(x, w, b, 2)
    assert a.shape == (2, 8) and off.shape == (2, 8)
    xq = torch.randn(1, 8, 4, 4)
    wq = torch.randn(8, 8, 3, 3, requires_grad=True)
    u = torch.full((8,), 0.05)
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_qconv.qconv3x3_fused(xq, wq, u, act=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_qconv.qconv3x3_fused(xq.requires_grad_(), wq.detach(), u, act=True)
    with torch.inference_mode():
        assert fused_qconv.qconv3x3_fused(xq, wq, u, act=True).shape == (1, 8, 4, 4)


# -- train loss and step ---------------------------------------------------

@pytest.fixture(scope="module")
def debug_models():
    """use_tpu's and the port's SGMSE_debug score models on one set of
    random weights (random_params, non-degenerate where the DDPM init
    zeroes convolutions)."""
    jm = JScoreModel(**DEBUG, backbone_kwargs={"remat": True, "remat_policy": "conv_outs"})
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=5)
    return jm, params


@pytest.fixture(scope="module")
def tiny_models():
    jm = JScoreModel(**TINY, backbone_kwargs=TINY_KWARGS)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=6)
    return jm, params


def _port(params, remat, policy="full", cfg=DEBUG, kwargs=None):
    tm = TScoreModel(**cfg, device="cpu",
                     backbone_kwargs=kwargs or {"remat": remat, "remat_policy": policy})
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    return tm


def _batch(seed, n=2, length=CLIP_LEN):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((n, length))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((n, length))).astype(np.float32)
    return {"clean": clean, "perturbed": noisy}


def jax_draws(jm, rng, batch):
    """use_tpu train_loss's (start, t, z) for `rng` (score_model.py:153-171)."""
    rng_crop, rng_t, rng_z = jax.random.split(rng, 3)
    n, length = batch["clean"].shape
    start = int(jax.random.randint(rng_crop, (), 0, max(length - jm.target_len, 1)))
    t = jax.random.uniform(rng_t, (n,)) * (jm.sde_obj.T - jm.t_eps) + jm.t_eps
    z = jcrandn(rng_z, (n, jm.stft_cfg.freqs, jm.num_frames, 2))
    return start, torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(net):
    return {k: p.grad for k, p in net.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def jax_loss_and_grads(debug_models):
    jm, params = debug_models
    batch = _batch(3)
    rng = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return batch, rng, float(loss), ncsnpp_params_to_state_dict(jax.device_get(grads))


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"), (True, "conv_outs")])
def test_train_loss_and_grads_match_jax(debug_models, jax_loss_and_grads, remat, policy):
    """The loss on use_tpu's draws and every parameter's gradient, mapped by
    the converter: rtol 1e-4 on the loss; gradients by ``_assert_grads``.
    The frozen Fourier W gets none, as use_tpu's stop_gradient."""
    jm, params = debug_models
    batch, rng, loss_j, grads_j = jax_loss_and_grads
    tm = _port(params, remat, policy)
    loss = tm.train_loss(_tensors(batch), draws=jax_draws(jm, rng, batch))
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-4 * abs(loss_j)
    grads = _grads(tm.score_net)
    assert set(grads) == set(grads_j) - {"all_modules.0.W"}
    assert not np.abs(grads_j["all_modules.0.W"].numpy()).any()
    _assert_grads(grads, grads_j)


def _assert_grads(grads, want):
    """Each gradient within 1e-3 relative plus 1e-4 x the largest of its
    tensor (fp32, a U-Net's sums in other orders; they agree to ~4e-6 of
    each tensor's largest), plus 1e-6 x the largest of all: the attention's
    key bias (NIN_1.b) has a zero gradient in exact arithmetic (softmax
    does not see a shift of the keys), which both sides round to ~1e-7."""
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in grads.items():
        assert_close(g, want[k], rtol=1e-3, atol=1e-4 * float(want[k].abs().max()) + 1e-6 * top)


def test_eval_and_drawn_losses_are_finite_and_seeded(debug_models):
    """Without injected draws the loss draws from the generator: one seed,
    one loss; the crop stays inside the clip and a short clip pads."""
    _, params = debug_models
    tm = _port(params, False)
    batch = _tensors(_batch(4))
    with torch.no_grad():
        a = tm.train_loss(batch, torch.Generator().manual_seed(1))
        b = tm.train_loss(batch, torch.Generator().manual_seed(1))
        short = tm.train_loss({k: v[:, :1000] for k, v in batch.items()},
                              torch.Generator().manual_seed(1))
    assert torch.isfinite(a) and float(a) == float(b) and torch.isfinite(short)
    start, t, z = tm.draw_train(2, CLIP_LEN, torch.Generator().manual_seed(2))
    assert 0 <= start < CLIP_LEN - tm.target_len
    assert t.shape == (2,) and float(t.min()) >= tm.t_eps and float(t.max()) < tm.sde_obj.T
    assert z.shape == (2, 128, 32, 2)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_gradients_are_the_group_mean_as_jax(tiny_models, accum):
    """One optimizer step over `accum` microbatches applies the MEAN of
    their gradients, as use_tpu's _accum_grads (the draws of each
    microbatch: split(rng, accum), then split(r, 3)). Tolerance as the
    loss test's."""
    jm, params = tiny_models
    micro = [_batch(10 + i, length=TINY_LEN) for i in range(accum)]
    rng = jax.random.PRNGKey(3)

    def loss_fn(p, b, r):
        return jm.train_loss(p, b, r), {}

    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
    if accum == 1:
        stacked = {k: v[0] for k, v in stacked.items()}
    loss_j, _, grads_j = jax.jit(lambda p, b, r: _accum_grads(loss_fn, p, b, r, accum))(
        params, stacked, rng)
    grads_j = ncsnpp_params_to_state_dict(jax.device_get(grads_j))
    rngs = [rng] if accum == 1 else list(jax.random.split(rng, accum))

    tm = _port(params, True, cfg=TINY, kwargs=TINY_KWARGS)
    state = TrainState.create(tm.score_net, toptim.adam(toptim.trainable(tm.score_net)))
    seen = {}
    real_apply = state.apply_gradients

    def recording():
        seen.update({k: g.clone() for k, g in _grads(tm.score_net).items()})
        real_apply()

    state.apply_gradients = recording
    out = sgmse_train_step(tm, state, [_tensors(m) for m in micro],
                           draws=[jax_draws(jm, r, m) for r, m in zip(rngs, micro)])
    assert state.step == 1
    assert abs(float(out["loss_Score"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert set(seen) == set(grads_j) - {"all_modules.0.W"}
    _assert_grads(seen, grads_j)


@pytest.mark.parametrize("gain", [1.0, 1e4])  # global norm below and far above the clip at 100
def test_optimizer_steps_match_jax(tiny_models, gain):
    """Three steps on the same gradients: clip by global norm (trainable
    parameters only), coupled L2 1e-7, Adam, frozen W untouched, EMA; the
    same fp32 update arithmetic in other orders: rtol 1e-5, atol 1e-7."""
    jm, params = tiny_models
    lr, decay = 1e-3, 0.9
    tx = joptim.adam(lr, 1e-7, grad_clip=100.0, params_example=params)
    jstate = JTrainState.create(params, tx, ema_decay=decay)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, tx))
    tm = _port(params, False, cfg=TINY, kwargs=TINY_KWARGS)
    net = tm.score_net
    state = TrainState.create(net, toptim.adam(toptim.trainable(net), lr, 1e-7),
                              grad_clip=100.0, ema_decay=decay)
    w0 = net.all_modules[0].W.detach().clone()
    rng = np.random.default_rng(9)
    for _ in range(3):
        gj = jax.tree.map(lambda p: (gain * rng.standard_normal(np.shape(p))).astype(np.float32),
                          params)
        # W's gradient is 0 on use_tpu's side (stop_gradient), and its mask
        # passes a gradient through unchanged: feed it the zero it gets
        gj["m0"]["W"] = np.zeros_like(gj["m0"]["W"])
        jstate = apply(jstate, gj)
        gt = ncsnpp_params_to_state_dict(gj)
        for k, p in net.named_parameters():
            p.grad = gt[k].clone() if p.requires_grad else None
        state.apply_gradients()
    assert state.step == 3
    want = ncsnpp_params_to_state_dict(jax.device_get(jstate.params))
    want_ema = ncsnpp_params_to_state_dict(jax.device_get(jstate.ema_params))
    for k, p in net.named_parameters():
        assert_close(p.detach(), want[k], rtol=1e-5, atol=1e-7)
        assert_close(state.ema_params[k], want_ema[k], rtol=1e-5, atol=1e-7)
    assert torch.equal(net.all_modules[0].W, w0)


def test_step_lr_matches_jax():
    j = joptim.step_lr(5e-4, step_size=30, gamma=0.5)
    t = toptim.step_lr(5e-4, step_size=30, gamma=0.5)
    for epoch in (0, 1, 29, 30, 59, 60, 95):
        assert abs(t(epoch) - float(j(epoch))) <= 1e-7 * t(epoch)  # use_tpu's is float32
    opt = toptim.adam([torch.nn.Parameter(torch.zeros(2))], lr=1.0)
    toptim.set_learning_rate(opt, t(60))
    assert opt.param_groups[0]["lr"] == 1.25e-4


def test_remat_launch_constants_of_chip_smoke():
    """chip_smoke's TRAIN_LAUNCHES: each kernel's calls per full-width
    ncsnpplarge microbatch (forward and backward), with the recipe's remat
    and without, counted here on a small input: the counts follow the
    structure, not the size (106 GroupNorms, 34 shortcuts a forward; under
    remat the 98 GroupNorms and 34 shortcuts inside residual blocks again)."""
    import chip_smoke

    counts = {}
    real = (gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd)

    def counting(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    got = {}
    try:
        gn_stats._channel_sums_fwd = counting("channel_sums", real[0])
        gn_stats._gn_apply_fwd = counting("gn_apply", real[1])
        fused_skip._fused_skip_add_fwd = counting("fused_skip_add", real[2])
        for remat in (True, False):
            counts.update(channel_sums=0, gn_apply=0, fused_skip_add=0)
            # 64 x 64 spectra reach ncsnpplarge's lowest level (7 levels: 1 x 1)
            tm = TScoreModel(**{**DEBUG, "backbone": "ncsnpplarge", "n_fft": 126,
                                "hop_length": 16, "num_frames": 64}, device="cpu",
                             backbone_kwargs={"remat": remat, "remat_policy": "conv_outs"})
            tm.train_loss(_tensors(_batch(6, n=1)), torch.Generator().manual_seed(0)).backward()
            got[remat] = {**counts, "qconv3x3_fused": 0}
    finally:
        gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd = real
    assert got[False] == {"channel_sums": 106, "gn_apply": 106, "fused_skip_add": 34,
                          "qconv3x3_fused": 0}
    assert got[True] == {"channel_sums": 204, "gn_apply": 204, "fused_skip_add": 68,
                         "qconv3x3_fused": 0}
    assert got[True] == chip_smoke.TRAIN_LAUNCHES["remat"]
    assert got[False] == chip_smoke.TRAIN_LAUNCHES["no_remat"]
