"""GroupNorm (kernel K1) parity: use_tpu_torch.ops.gn_stats's plain versions
against use_tpu.ops.gn_stats (its XLA path on the CPU), and the port's
GroupNormAct against use_tpu's with the same affine params. On the CPU the
wrappers take the plain versions; the CUDA kernels are held against those on
the card by chip_smoke.py. Tolerance rtol 1e-5 (atol 1e-5 for outputs near
zero)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import nchw_to_nhwc, nhwc_to_nchw, random_params
from use_tpu.models.ncsnpp import layers as jl
from use_tpu.ops import gn_stats as jgn
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp import layers as tl
from use_tpu_torch.ops import gn_stats as tgn

RTOL = ATOL = 1e-5


def _bsc(seed, shape=(3, 64, 24)):
    return (1.5 + np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_channel_sums_match_jax():
    x = _bsc(0)  # [B, S, C], use_tpu's layout
    s_j, ss_j = jgn.channel_sums(jnp.asarray(x))
    s_t, ss_t = tgn.channel_sums(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    np.testing.assert_allclose(ss_t.numpy(), np.asarray(ss_j), rtol=RTOL)


def test_group_mean_meansq_match_jax():
    x = _bsc(1)
    m_j, msq_j = jgn.group_mean_meansq(jnp.asarray(x), 6)
    m_t, msq_t = tgn.group_mean_meansq(torch.from_numpy(x.transpose(0, 2, 1).copy()), 6)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL)
    np.testing.assert_allclose(msq_t.numpy(), np.asarray(msq_j), rtol=RTOL)


@pytest.mark.parametrize("act", ["swish", None])
@pytest.mark.parametrize("channels", [16, 48, 96])
def test_group_norm_act_matches_jax(channels, act):
    x = (0.5 + np.random.default_rng(channels).standard_normal((2, 6, 10, channels))).astype(np.float32)
    jmod = jl.GroupNormAct(channels, act=jax.nn.silu if act else None)
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], seed=3)
    want = np.asarray(jmod.apply({"params": params}, x))

    tmod = tl.GroupNormAct(channels, act=act)
    tmod.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    assert tmod.groups == min(max(channels // 4, 1), 32)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=RTOL, atol=ATOL)


def test_gn_apply_clamps_variance_and_casts():
    # a constant channel group: E[x^2] - E[x]^2 may round below zero
    x = torch.full((1, 4, 32), 3.0)
    s, ss = tgn.channel_sums(x)
    y = tgn.gn_apply(x, s, ss, torch.ones(4), torch.zeros(4), groups=1, act="swish",
                     out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("rows,s", [(128, 786432), (256, 8), (1, 5), (1024, 98304)])
def test_split_rows_covers_each_row(rows, s):
    splits, chunk = tgn.split_rows(rows, s)
    assert chunk % 4 == 0 and 1 <= splits <= 65535
    assert (splits - 1) * chunk < s <= splits * chunk


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError):
        tgn.channel_sums(x)
    with pytest.raises(ValueError):
        tgn.gn_apply(x, torch.empty((1, 4), device="meta"), torch.empty((1, 4), device="meta"),
                     torch.ones(4), torch.zeros(4), groups=1)
