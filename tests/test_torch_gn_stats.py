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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _row_visits(rows, s, cg):
    """How often the statistics launch of split_rows / rows_per_block visits
    each row (short rows: warp w of a block takes rows w, w + 8, ... of the
    block's rows_per_block, as stats_rows_kernel does) and, per row, which
    elements (long rows: block (r, j) takes [j * chunk, (j + 1) * chunk))."""
    splits, chunk = tgn.split_rows(rows, s)
    visits = np.zeros(rows, np.int64)
    if splits == 1:
        per_block = tgn.rows_per_block(cg)
        assert per_block % cg == 0 and per_block >= min(cg, 8)
        for r0 in range(0, rows, per_block):
            assert r0 % cg == 0  # a block starts on a group
            for warp in range(8):
                for k in range(warp, per_block, 8):
                    if r0 + k < rows:
                        visits[r0 + k] += 1
        return visits, [(0, s)]
    assert chunk % 8 == 0
    slices = [(j * chunk, min(s, (j + 1) * chunk)) for j in range(splits)]
    visits += 1  # block (r, j) for each row r: every row gets all its slices
    return visits, slices


@pytest.mark.parametrize("channels", [128, 256], ids=["cg4", "cg8"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("s", [24, 37, tgn._MIN_CHUNK - 8, tgn._MIN_CHUNK, tgn._MIN_CHUNK + 1,
                               2 * tgn._MIN_CHUNK + 3, 98304])
def test_stats_launch_covers_each_row_once(batch, channels, s):
    cg = channels // tgn.num_groups(channels)
    assert cg == channels // 32
    rows = batch * channels
    visits, slices = _row_visits(rows, s, cg)
    np.testing.assert_array_equal(visits, np.ones(rows, np.int64))
    covered = np.zeros(s, np.int64)
    for begin, end in slices:
        assert begin < end
        covered[begin:end] += 1
    np.testing.assert_array_equal(covered, np.ones(s, np.int64))


def test_short_rows_at_every_low_level():
    # every batch-8 level from 128 x 48 down is one launch without partials
    for c, s in ((256, 128 * 48), (256, 64 * 24), (256, 32 * 12), (512, 16 * 6), (256, 8 * 3)):
        assert tgn.split_rows(8 * c, s)[0] == 1
    assert tgn.split_rows(8 * 128, 512 * 192)[0] > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [64, 128])
def test_gn_fold_plain_matches_jax_fold(channels, dtype):
    """use_tpu's GroupNormAct(quant='fold') squares a bf16 input in bf16 on
    its XLA path (its comment: ~2^-9 relative), while its Pallas K1 widens
    to fp32 first, as the port does: so use_tpu's fold is fed the input's
    values widened to fp32, the values K1 sums."""
    rng = np.random.default_rng(channels)
    x = (0.5 + rng.standard_normal((2, 6, 10, channels))).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = nhwc_to_nchw(x).to(tdt)
    x = nchw_to_nhwc(xt.float())
    jmod = jl.GroupNormAct(channels, act=jax.nn.silu, quant="fold")
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], seed=9)
    ja, joff, _ = (np.asarray(v) for v in jmod.apply({"params": params}, x))
    sd = ncsnpp_params_to_state_dict(params)
    a, off = tgn.gn_fold(xt.reshape(2, channels, -1), sd["weight"], sd["bias"],
                         tgn.num_groups(channels))
    assert a.dtype == off.dtype == torch.float32 and a.shape == off.shape == (2, channels)
    np.testing.assert_allclose(a.numpy(), ja, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(off.numpy(), joff, rtol=RTOL, atol=ATOL)


def test_groupnorm_fold_module_unchanged():
    """GroupNormAct(quant='fold') gives the (a, off, u) of channel sums
    folded by fold_scale_shift, and the k-sigma u, bit for bit."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((0.3 + rng.standard_normal((2, 48, 5, 7))).astype(np.float32))
    mod = tl.GroupNormAct(48, act="swish", quant="fold")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(48).astype(np.float32)))
        mod.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(48).astype(np.float32)))
        a, off, u = mod(x)
    x3 = x.reshape(2, 48, -1)
    want_a, want_off = tgn.fold_scale_shift(*tgn.channel_sums(x3), mod.weight, mod.bias,
                                            mod.groups, x3.shape[2], mod.eps)
    want_u = (mod.bias.abs() + 6.0 * mod.weight.abs()) / 127.0 + 1e-12
    assert torch.equal(a, want_a) and torch.equal(off, want_off)
    torch.testing.assert_close(u, want_u.detach(), rtol=0, atol=0)


def test_gn_fold_rejects_other_devices():
    x = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError):
        tgn.gn_fold(x, torch.ones(8), torch.zeros(8), groups=2)
