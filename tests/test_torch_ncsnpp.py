"""NCSN++ parity: use_tpu_torch's blocks and U-Net against use_tpu's, with
the same random weights (converted by engine/convert_jax.py) and inputs.

Both sides run in fp32 on the CPU; the port takes the plain versions of its
kernels there (GroupNorm stats/apply, fused shortcut). Tolerance rtol 1e-4,
atol 1e-5: the two frameworks sum convolutions in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, random_params,
)
from use_tpu.engine.convert_torch import convert_ncsnpp_state_dict
from use_tpu.models.ncsnpp import layers as jl
from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp import layers as tl
from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as TNCSNpp, NCSNppConfig as TConfig

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_apply(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args))


@pytest.mark.parametrize(
    "in_ch,out_ch,up,down",
    [(16, 16, False, False), (16, 16, True, False), (16, 16, False, True), (16, 32, False, False)],
    ids=["plain", "up", "down", "channels"],
)
def test_resnet_biggan_block_matches_jax(in_ch, out_ch, up, down):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jblock = jl.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=out_ch, up=up, down=down, fir=True,
                                    temb_dim=32)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, temb)["params"]
    params = random_params(shapes, seed=1)
    want = _jax_apply(jblock, params, x, temb)

    tblock = tl.ResnetBlockBigGANpp(act="swish", in_ch=in_ch, out_ch=out_ch, up=up, down=down,
                                    fir=True, temb_dim=32)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    assert (tblock.Conv_2 is not None) == (in_ch != out_ch or up or down)
    with torch.no_grad():
        got = tblock.eval()(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, RTOL, ATOL)


@pytest.mark.parametrize("conv_shortcut", [False, True], ids=["nin", "conv"])
def test_resnet_ddpm_block_matches_jax(conv_shortcut):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jblock = jl.ResnetBlockDDPMpp(act=jax.nn.silu, out_ch=32, conv_shortcut=conv_shortcut,
                                  skip_rescale=True, temb_dim=32)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, temb)["params"]
    params = random_params(shapes, seed=3)
    want = _jax_apply(jblock, params, x, temb)

    tblock = tl.ResnetBlockDDPMpp(act="swish", in_ch=16, out_ch=32, conv_shortcut=conv_shortcut,
                                  skip_rescale=True, temb_dim=32)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tblock.eval()(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, RTOL, ATOL)


def test_attn_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    jblock = jl.AttnBlockpp(skip_rescale=True)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x)["params"]
    params = random_params(shapes, seed=5)
    want = _jax_apply(jblock, params, x)

    tblock = tl.AttnBlockpp(32, skip_rescale=True)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tblock(nhwc_to_nchw(x))
    assert_close(nchw_to_nhwc(got), want, RTOL, ATOL)


TINY = dict(nf=16, ch_mult=(1, 2, 2))


def _tiny_params(seed):
    x = np.zeros((1, 32, 64, 4), np.float32)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**TINY)).init, jax.random.PRNGKey(0), x,
                            jnp.full((1,), 0.5))["params"]
    return random_params(shapes, seed)


def test_tiny_ncsnpp_forward_matches_jax():
    params = _tiny_params(seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 64, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = _jax_apply(JNCSNpp(JConfig(**TINY)), params, x, t)

    net = TNCSNpp(TConfig(**TINY))
    net.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == want.shape == (2, 32, 64, 1, 2)
    assert_close(got.numpy(), want, RTOL, ATOL)


def test_ncsnpplarge_param_count_matches_jax():
    import use_tpu.models  # noqa: F401
    import use_tpu_torch.models  # noqa: F401
    from use_tpu.models import BackboneRegistry as JReg
    from use_tpu_torch.models import BackboneRegistry as TReg

    jnet = JReg.get_by_name("ncsnpplarge")(input_channels=4)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 64, 4)),
                            jnp.full((1,), 0.5))["params"]
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
    n_torch = sum(p.numel() for p in TReg.get_by_name("ncsnpplarge")(input_channels=4).parameters())
    assert n_jax == n_torch == 64_799_782


def test_converter_round_trips_through_use_tpu():
    """convert_jax (Flax -> torch) followed by use_tpu's convert_torch
    (torch -> Flax) gives back the same tree, leaf for leaf."""
    params = _tiny_params(seed=8)
    back = convert_ncsnpp_state_dict(ncsnpp_params_to_state_dict(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_config_keys_quant_raises_and_remat_is_accepted():
    with pytest.raises(ValueError, match="none \\| int8 \\| int8_pallas"):
        TNCSNpp(TConfig(**TINY, quant="int4"))
    assert any(isinstance(m, tl.QConv)
               for m in TNCSNpp(TConfig(**TINY, quant="int8", quant_min_channels=16)).modules())
    net = TNCSNpp(TConfig(**TINY, remat=True, remat_policy="conv_outs"))
    assert sum(p.numel() for p in net.parameters()) > 0
    qnet = TNCSNpp(TConfig(**TINY, quant="int8_pallas", quant_min_channels=16))
    assert any(isinstance(m, tl.FusedQConv3x3) for m in qnet.modules())
    assert qnet.state_dict().keys() == net.state_dict().keys()
