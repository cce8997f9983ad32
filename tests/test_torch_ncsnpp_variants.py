"""NCSN++ variants: use_tpu_torch's Upsample / Downsample layers, the FIR
resampling convs (upsample_conv_2d, conv_downsample_2d), fused_leaky_relu,
and the U-Net with resblock_type='ddpm' and progressive / progressive_input
'residual' against use_tpu's, with inputs and weights drawn with numpy from
a seed, fp32 on the CPU.

Tolerances: the layers and ops at rtol 1e-5 / atol 1e-6 (one or two
convolutions summed in other orders); fused_leaky_relu is elementwise and
bit-equal; the U-Net's forward at rtol 1e-4 / atol 1e-5 x max|ref| (1e-4 of
test_torch_ncsnpp.py's U-Net, about a hundred layers); one SGMSE train
step's loss at rtol 1e-4 and its gradients as test_torch_train.py holds
them (each within 1e-3 relative plus 1e-4 x its tensor's largest; the 2e-4
of chip_smoke's card-vs-CPU gradients is looser).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import assert_close, nchw_to_nhwc, nhwc_to_nchw, random_params
from tests.test_torch_train import (  # noqa: F401 (_two_torch_threads: fixture)
    _assert_grads, _batch, _grads, _tensors, _two_torch_threads, jax_draws,
)
from use_tpu.engine.convert_torch import convert_ncsnpp_state_dict
from use_tpu.models.ncsnpp import layers as jl
from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu.ops import fused_act as jfa
from use_tpu.ops import upfirdn2d as jup
from use_tpu_torch.engine import optim as toptim
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.engine.state import TrainState
from use_tpu_torch.engine.train import sgmse_train_step
from use_tpu_torch.models.ncsnpp import layers as tl
from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as TNCSNpp, NCSNppConfig as TConfig
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel
from use_tpu_torch.ops import fused_act as tfa
from use_tpu_torch.ops import upfirdn2d as tup

OP_RTOL, OP_ATOL = 1e-5, 1e-6
NET_RTOL, NET_ATOL = 1e-4, 1e-5
FIR = (1.0, 3.0, 3.0, 1.0)
VARIANT = dict(resblock_type="ddpm", progressive="residual", progressive_input="residual")


def _hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


@pytest.mark.parametrize("op", ["upsample_conv_2d", "conv_downsample_2d"])
@pytest.mark.parametrize("c,o,k", [(8, 12, FIR), (5, 3, (1.0, 2.0, 1.0))])
def test_fir_resampling_convs_match_jax(op, c, o, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 10, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    want = np.asarray(getattr(jup, op)(jnp.asarray(x), jnp.asarray(w), k=k))
    got = getattr(tup, op)(nhwc_to_nchw(x), _hwio_to_oihw(w), k=k)
    assert nchw_to_nhwc(got).shape == want.shape
    assert_close(nchw_to_nhwc(got), want, OP_RTOL, OP_ATOL)


@pytest.mark.parametrize("bias", [True, False])
def test_fused_leaky_relu_bit_equal_to_jax(bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32) if bias else None
    want = np.asarray(jfa.fused_leaky_relu(jnp.asarray(x), None if b is None else jnp.asarray(b)))
    got = tfa.fused_leaky_relu(torch.from_numpy(x), None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layer", ["Upsample", "Downsample"])
@pytest.mark.parametrize("fir,with_conv", [(True, True), (True, False), (False, True),
                                           (False, False)])
def test_resampling_layers_match_jax(layer, fir, with_conv):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 12, 6)).astype(np.float32)
    out_ch = 10 if with_conv else None
    jlayer = getattr(jl, layer)(out_ch=out_ch, with_conv=with_conv, fir=fir, fir_kernel=FIR)
    variables = jlayer.init(jax.random.PRNGKey(0), x)
    params = random_params(variables.get("params", {}), seed=3)
    want = np.asarray(jlayer.apply({"params": params}, x))
    tlayer = getattr(tl, layer)(6, out_ch, with_conv=with_conv, fir=fir, fir_kernel=FIR)
    tlayer.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tlayer(nhwc_to_nchw(x))
    assert nchw_to_nhwc(got).shape == want.shape
    assert_close(nchw_to_nhwc(got), want, OP_RTOL, OP_ATOL)


NET = dict(nf=16, ch_mult=(1, 2, 2))


def _params(cfg, seed):
    x0 = np.zeros((1, 32, 64, 4), np.float32)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**cfg)).init, jax.random.PRNGKey(0), x0,
                            jnp.full((1,), 0.5))["params"]
    return random_params(shapes, seed=seed)


@pytest.mark.parametrize("variant", [
    dict(VARIANT, fir=True), dict(VARIANT, fir=False),
    dict(resblock_type="ddpm", resamp_with_conv=False, fir=False),
    dict(progressive="residual", progressive_input="residual"),
], ids=["ddpm_residual_fir", "ddpm_residual_nofir", "ddpm_plain_resampling",
        "biggan_residual"])
def test_tiny_ncsnpp_variant_forward_matches_jax(variant):
    cfg = dict(NET, **variant)
    params = _params(cfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 64, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(JNCSNpp(JConfig(**cfg)).apply({"params": params}, x, t))
    net = TNCSNpp(TConfig(**cfg))
    net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 32, 64, 1, 2)
    assert_close(got, want, NET_RTOL, NET_ATOL * float(np.abs(want).max()))


def test_variant_converter_round_trips_through_use_tpu():
    """convert_jax (Flax -> torch) then use_tpu's convert_torch (torch ->
    Flax) gives back the same tree, the Upsample / Downsample convs
    (Conv2d_0_weight, Conv_0) included."""
    params = _params(dict(NET, **VARIANT), seed=6)
    back = convert_ncsnpp_state_dict(ncsnpp_params_to_state_dict(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    assert any("Conv2d_0_weight" in jax.tree_util.keystr(p) for p, _ in flat_a)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_variant_train_step_gradients_match_jax():
    """One SGMSE optimizer step (sgmse_train_step) of a tiny ddpm / residual
    / residual score net on use_tpu's draws: its loss and the gradients it
    applies, every one against use_tpu's."""
    model = dict(backbone="ncsnpp", sde="ouve", t_eps=0.03, condition="noisy",
                 sde_input="noisy", loss_type="mse", n_fft=62, hop_length=16, num_frames=32)
    kwargs = dict(NET, **VARIANT)
    jm = JScoreModel(**model, backbone_kwargs=kwargs)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=7)
    batch = _batch(8, length=600)
    rng = jax.random.PRNGKey(9)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jm.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    grads_j = ncsnpp_params_to_state_dict(jax.device_get(grads_j))

    tm = TScoreModel(**model, device="cpu", backbone_kwargs=kwargs)
    tm.score_net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    state = TrainState.create(tm.score_net, toptim.adam(toptim.trainable(tm.score_net)))
    seen = {}
    real_apply = state.apply_gradients

    def recording():
        seen.update({k: g.clone() for k, g in _grads(tm.score_net).items()})
        real_apply()

    state.apply_gradients = recording
    out = sgmse_train_step(tm, state, [_tensors(batch)], draws=[jax_draws(jm, rng, batch)])
    assert state.step == 1
    assert abs(float(out["loss_Score"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert set(seen) == set(grads_j) - {"all_modules.0.W"}
    assert any("Conv2d_0" in k for k in seen)
    _assert_grads(seen, grads_j)


def test_ddpm_launch_constants_of_chip_smoke(monkeypatch):
    """chip_smoke's PER_DDPM_FORWARD: one forward of the DDPM /
    residual-pyramid ncsnpplarge calls K1's statistics and apply 77 times
    each and no other kernel (its shortcuts are NINs), counted on a 64 x 64
    input, FIR on and off."""
    import chip_smoke
    from tests.test_torch_int8conv import _count_kernel_calls
    from use_tpu_torch.models import BackboneRegistry

    counts = _count_kernel_calls(monkeypatch)
    for fir in (True, False):
        for k in counts:
            counts[k] = 0
        net = BackboneRegistry.get_by_name("ncsnpplarge")(input_channels=4, fir=fir,
                                                          **chip_smoke.DDPM_KWARGS)
        with torch.inference_mode():
            net(torch.zeros((1, 64, 64, 4)), torch.tensor([0.5]))
        assert counts == chip_smoke.all_kernels(chip_smoke.PER_DDPM_FORWARD)
    assert chip_smoke.PER_DDPM_FORWARD == {"channel_sums": 77, "gn_apply": 77}


def test_ddpm_block_hands_on_contiguous_nchw():
    """A DDPM block whose NIN shortcut changes the channels returns
    contiguous NCHW, as the next GroupNorm's kernels take it on the card
    (the NIN works channels-last)."""
    block = tl.ResnetBlockDDPMpp(act="swish", in_ch=16, out_ch=32, temb_dim=8)
    with torch.no_grad():
        out = block(torch.randn(2, 16, 6, 5), torch.randn(2, 8))
    assert out.shape == (2, 32, 6, 5) and out.is_contiguous()
