"""quant='int8' parity: use_tpu_torch's int8 ops (ops/qconv.py), K1's apply
with its int8 epilogue, GroupNormAct's 'out' and 'scale' modes, the int8
BigGAN and DDPM blocks and a tiny int8 U-Net against use_tpu's, with inputs
and weights drawn with numpy from a seed. On the port's side the wrappers
take their plain versions on CPU tensors (on the card the kernels are held
bit-equal to them by chip_smoke.py).

Tolerances:
- The quantizers are the same IEEE divisions, roundings (half to even) and
  clips on both sides: bit-equal (rtol 0, atol 0), and so are the int8
  tensors and scales that qconv2d / qconv2d_prequant make; their outputs are
  integer sums times the same fp32 scales, held at use_tpu's own test
  tolerance (tests/test_qconv.py: rtol 1e-5, atol 1e-5).
- GroupNormAct 'out' / 'scale': the GroupNorm statistics are summed in
  another order, so y may differ in its last bits, and the int8 values are
  allowed no flip at these seeds; u is bit-equal; y at rtol 1e-5.
- Blocks: BLOCK_RTOL 1e-4 / BLOCK_ATOL 1e-5, the fp32 block tolerance of
  test_torch_ncsnpp.py (no quantum flips at these seeds, none allowed).
- The U-Net: a last-bit difference of a GroupNorm statistic somewhere can
  flip one quantum, which spreads through the following blocks, so the
  end-to-end output is held to a relative L2 of 0.05, as
  test_torch_qconv.py holds the int8_pallas U-Net; what is exact there is
  checked exactly: every quantized conv call, in order, with the same
  operand shape, int8 weights and dequant scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, random_params,
)
from tests.test_torch_train import _two_torch_threads  # noqa: F401 (fixture)
from use_tpu.models.ncsnpp import layers as jl
from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
from use_tpu.ops import qconv as jqc
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp import layers as tl
from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as TNCSNpp, NCSNppConfig as TConfig
from use_tpu_torch.ops import gn_stats as tg
from use_tpu_torch.ops import qconv as tqc

OP_RTOL, OP_ATOL = 1e-5, 1e-5
BLOCK_RTOL, BLOCK_ATOL = 1e-4, 1e-5
MODEL_REL_L2 = 0.05


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a)) if a.ndim else torch.tensor(a.item())


def _hwio_to_oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _oihw_to_hwio(w):
    return w.numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_per_sample_bit_equal_to_jax(dtype):
    x = np.random.default_rng(0).standard_normal((3, 5, 7, 8)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    q, s = jqc.quantize_per_sample(jx)
    tq, ts = tqc.quantize_per_sample(nhwc_to_nchw(np.asarray(jx.astype(jnp.float32)))
                                     .to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.permute(0, 2, 3, 1).numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_quantize_weight_per_cout_bit_equal_to_jax():
    k = (0.1 * np.random.default_rng(1).standard_normal((3, 3, 36, 40))).astype(np.float32)
    k[:, :, :, 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    q, s = jqc.quantize_weight_per_cout(jnp.asarray(k))
    tq, ts = tqc.quantize_weight_per_cout(_hwio_to_oihw(k))
    np.testing.assert_array_equal(_oihw_to_hwio(tq), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("per_channel", [True, False], ids=["per_channel", "scalar"])
def test_quantize_with_scale_bit_equal_to_jax(per_channel):
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((2, 6, 5, 16))).astype(np.float32)
    s = (0.01 + 0.02 * rng.random(16) if per_channel else np.array(0.02)).astype(np.float32)
    want = np.asarray(jqc.quantize_with_scale(jnp.asarray(x), jnp.asarray(s)))
    got = tqc.quantize_with_scale(nhwc_to_nchw(x), _t(s))
    assert got.dtype == torch.int8 and (np.abs(want) == 127).any()  # some clipped
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("c,o,out_dtype", [(8, 12, "float32"), (36, 40, "bfloat16")])
def test_qconv2d_matches_jax(c, o, out_dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 9, c)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, c, o))).astype(np.float32)
    want = np.asarray(jqc.qconv2d(jnp.asarray(x), jnp.asarray(k), padding=[(1, 1), (1, 1)],
                                  out_dtype=getattr(jnp, out_dtype)).astype(jnp.float32))
    launches = tqc.qconv3x3_s8.launches
    got = tqc.qconv2d(nhwc_to_nchw(x), _hwio_to_oihw(k), out_dtype=getattr(torch, out_dtype))
    assert tqc.qconv3x3_s8.launches == launches  # CPU tensors: the plain version
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (2, o, 6, 9)
    if out_dtype == "float32":
        assert_close(nchw_to_nhwc(got), want, OP_RTOL, OP_ATOL)
    else:  # one bf16 rounding of nearly the same value: one ulp
        assert_close(nchw_to_nhwc(got), want, 2.0 ** -7, OP_ATOL)


@pytest.mark.parametrize("per_channel", [True, False], ids=["per_channel", "scalar"])
def test_qconv2d_prequant_matches_jax(monkeypatch, per_channel):
    """The int8 weights and scales use_tpu makes (recorded from its
    quantize_weight_per_cout) are the port's, bit for bit; the output at
    use_tpu's test tolerance."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 9, 24)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, 24, 16))).astype(np.float32)
    s = (0.01 + 0.02 * rng.random(24) if per_channel else np.array(0.03)).astype(np.float32)
    qx = jqc.quantize_with_scale(jnp.asarray(x), jnp.asarray(s))
    seen = []
    real = jqc.quantize_weight_per_cout
    monkeypatch.setattr(jqc, "quantize_weight_per_cout",
                        lambda w: seen.append(real(w)) or seen[-1])
    want = np.asarray(jqc.qconv2d_prequant(qx, jnp.asarray(s), jnp.asarray(k),
                                           padding=[(1, 1), (1, 1)]))
    tqx = nhwc_to_nchw(np.asarray(qx))
    assert tqx.dtype == torch.int8
    got = tqc.qconv2d_prequant(tqx, _t(s), _hwio_to_oihw(k))
    prepared = tqc.prepare_s8_weight(_hwio_to_oihw(k), _t(s) if per_channel else None)
    (jq, js), = seen
    np.testing.assert_array_equal(_oihw_to_hwio(prepared.qw), np.asarray(jq))
    np.testing.assert_array_equal(prepared.sw.numpy(), np.asarray(js))
    assert_close(nchw_to_nhwc(got), want, OP_RTOL, OP_ATOL)


def test_s8_conv_plain_is_exact_and_wrapper_dispatches():
    """The plain conv sums int8 values exactly (float64), here to values an
    fp32 sum would round, and s8_conv takes it for CPU tensors; the dequant
    rounds to out_dtype before the bias is added in out_dtype."""
    rng = np.random.default_rng(5)
    qx = _t(rng.choice([-127, 127], (1, 256, 5, 6), p=[0.1, 0.9]).astype(np.int8))
    qw = torch.full((3, 256, 3, 3), 127, dtype=torch.int8)
    acc = torch.nn.functional.conv2d(qx.long(), qw.long(), padding=1)
    assert int(acc.abs().max()) > 2 ** 24
    scale, bias = torch.tensor([1.0, 0.5, 3e-3]), torch.tensor([0.25, -1.0, 7.0])
    got = tqc.s8_conv_plain(qx, qw, scale, bias, torch.bfloat16)
    want = ((acc.double().float() * scale[None, :, None, None]).to(torch.bfloat16)
            + bias.to(torch.bfloat16)[None, :, None, None])
    assert torch.equal(got, want)
    prepared = tqc.S8Weights(qw, scale, None)
    launches = tqc.qconv3x3_s8.launches
    torch.testing.assert_close(tqc.s8_conv(qx, prepared, 2.0, bias, torch.float32),
                               tqc.s8_conv_plain(qx, qw, scale * 2.0, bias), rtol=0, atol=0)
    assert tqc.qconv3x3_s8.launches == launches


@pytest.mark.parametrize("kernel,stride,padding,dilation", [
    (1, 1, 0, 1), (3, 2, 1, 1), (3, 1, 2, 2), (3, 1, 0, 1)])
def test_s8_conv_refuses_other_geometries_off_the_cpu(kernel, stride, padding, dilation):
    """Off the CPU the conv is the kernel's, which takes a 3x3 conv with
    stride, padding and dilation 1 only: another geometry raises, naming it,
    and never falls back to the plain version (meta tensors stand in for the
    card's here)."""
    qx = torch.zeros((1, 8, 6, 6), dtype=torch.int8, device="meta")
    prepared = tqc.S8Weights(torch.zeros((4, 8, kernel, kernel), dtype=torch.int8, device="meta"),
                             torch.ones(4, device="meta"), None)
    with pytest.raises(ValueError, match=f"got kernel \\({kernel}, {kernel}\\), stride {stride}"):
        tqc.s8_conv(qx, prepared, None, None, torch.float32, stride, padding, dilation)
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        tqc.qconv3x3_s8(qx, prepared)


@pytest.mark.parametrize("act", ["swish", "lrelu", None])
def test_gn_apply_int8_wrapper_is_its_plain_version(act):
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((2, 16, 30)).astype(np.float32))
    a, off = _t(rng.standard_normal((2, 16)).astype(np.float32)), _t(
        rng.standard_normal((2, 16)).astype(np.float32))
    u = _t((0.01 + 0.02 * rng.random(16)).astype(np.float32))
    launches = tg.gn_apply_int8.launches
    got = tg.gn_apply_int8(x, a, off, u, act, torch.bfloat16)
    assert tg.gn_apply_int8.launches == launches
    y = tg._act_plain(x * a[:, :, None] + off[:, :, None], act).to(torch.bfloat16)
    want = torch.clamp(torch.round(y.float() / u[None, :, None]), -127, 127).to(torch.int8)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got, tg.gn_apply_int8_plain(x, a, off, u, act, torch.bfloat16))


@pytest.mark.parametrize("mode", ["out", "scale"])
def test_groupnorm_int8_modes_match_jax(mode):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 12, 64)).astype(np.float32)
    jgn = jl.GroupNormAct(64, act=jax.nn.silu, quant=mode)
    params = random_params(jax.eval_shape(jgn.init, jax.random.PRNGKey(0), x)["params"], seed=8)
    jy, ju = (np.asarray(v) for v in jgn.apply({"params": params}, x))
    tgn = tl.GroupNormAct(64, act="swish", quant=mode)
    tgn.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        ty, tu = tgn(nhwc_to_nchw(x))
    np.testing.assert_array_equal(tu.numpy(), ju)
    if mode == "out":
        ty = tqc.unpack_c32(ty, 64)  # the int8 conv's operand layout -> NCHW
        assert ty.dtype == torch.int8 and (np.abs(jy) > 60).any()
        np.testing.assert_array_equal(ty.permute(0, 2, 3, 1).numpy(), jy)
    else:
        assert ty.dtype == torch.float32
        assert_close(nchw_to_nhwc(ty), jy, 1e-5, 1e-6)


@pytest.mark.parametrize(
    "in_ch,out_ch,up,down",
    [(16, 16, False, False), (16, 16, True, False), (16, 16, False, True), (16, 32, False, False)],
    ids=["plain", "up", "down", "channels"],
)
def test_int8_biggan_block_matches_jax(in_ch, out_ch, up, down):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    kw = dict(up=up, down=down, fir=True, temb_dim=32, quant="int8", quant_min_channels=1)
    jblock = jl.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=out_ch, **kw)
    params = random_params(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, temb)["params"],
                           seed=1)
    want = np.asarray(jblock.apply({"params": params}, x, temb))

    tblock = tl.ResnetBlockBigGANpp(act="swish", in_ch=in_ch, out_ch=out_ch, **kw)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    assert (tblock.q0, tblock.q1, tblock.qp0, tblock.qp1) == (True, True, False, False)
    assert isinstance(tblock.Conv_0, tl.QConv) and isinstance(tblock.Conv_1, tl.QConv)
    assert tblock.GroupNorm_0.quant == ("scale" if up or down else "out")
    with torch.no_grad():
        got = tblock.eval()(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, BLOCK_RTOL, BLOCK_ATOL)


@pytest.mark.parametrize("in_ch,out_ch", [(16, 16), (16, 32)], ids=["plain", "channels"])
def test_int8_ddpm_block_matches_jax(in_ch, out_ch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 12, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    kw = dict(temb_dim=32, quant="int8", quant_min_channels=1)
    jblock = jl.ResnetBlockDDPMpp(act=jax.nn.silu, out_ch=out_ch, **kw)
    params = random_params(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, temb)["params"],
                           seed=3)
    want = np.asarray(jblock.apply({"params": params}, x, temb))
    tblock = tl.ResnetBlockDDPMpp(act="swish", in_ch=in_ch, out_ch=out_ch, **kw)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    assert (tblock.q0, tblock.q1) == (True, True)
    with torch.no_grad():
        got = tblock.eval()(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, BLOCK_RTOL, BLOCK_ATOL)


TINY = dict(nf=16, ch_mult=(1, 2, 2))


@pytest.mark.parametrize("resblock_type", ["biggan", "ddpm"])
def test_tiny_int8_ncsnpp_matches_jax(monkeypatch, resblock_type):
    """Every quantized conv call of a tiny int8 U-Net, in order: the same
    operand shape, int8 weights and dequant scales as use_tpu's (recorded
    where each side quantizes its weight); the output within MODEL_REL_L2."""
    jcalls, tcalls = [], []
    jreal, treal = jqc.quantize_weight_per_cout, tqc.quantize_weight_per_cout
    jprequant = jqc.qconv2d_prequant

    def jrecord(qx, in_scale, kernel, **kw):
        jcalls.append([np.asarray(qx).shape])
        return jprequant(qx, in_scale, kernel, **kw)

    def jweights(w):
        q, s = jreal(w)
        jcalls[-1] += [np.asarray(q), np.asarray(s)]
        return q, s

    real_s8 = tqc.s8_conv

    def trecord(qx, prepared, *args, **kw):
        nchw = tqc.unpack_c32(qx, prepared.qw.shape[1])  # the operand arrives as C32
        tcalls.append([tuple(nchw.permute(0, 2, 3, 1).shape), _oihw_to_hwio(prepared.qw),
                       prepared.sw.numpy()])
        return real_s8(qx, prepared, *args, **kw)

    monkeypatch.setattr(jqc, "qconv2d_prequant", jrecord)
    monkeypatch.setattr(jqc, "quantize_weight_per_cout", jweights)
    monkeypatch.setattr(tqc, "s8_conv", trecord)
    cfg = dict(TINY, resblock_type=resblock_type)
    x0 = np.zeros((1, 32, 64, 4), np.float32)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**cfg)).init, jax.random.PRNGKey(0), x0,
                            jnp.full((1,), 0.5))["params"]
    params = random_params(shapes, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 64, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    int8 = dict(cfg, quant="int8", quant_min_channels=16)
    want = np.asarray(JNCSNpp(JConfig(**int8)).apply({"params": params}, x, t))

    state = ncsnpp_params_to_state_dict(params)
    net = TNCSNpp(TConfig(**int8))
    net.load_state_dict(state, strict=True)
    fnet = TNCSNpp(TConfig(**cfg))
    fnet.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net(_t(x), _t(t)).numpy()
        fp32 = fnet(_t(x), _t(t)).numpy()

    n_q = sum(isinstance(m, tl.QConv) for m in net.modules())
    assert n_q == len(tcalls) == len(jcalls) == (30 if resblock_type == "biggan" else 22)
    for (js, jk, jsw), (ts, tk, tsw) in zip(jcalls, tcalls):
        assert js == ts
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tsw, jsw)
    assert got.shape == want.shape == (2, 32, 64, 1, 2)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= MODEL_REL_L2, rel
    assert np.linalg.norm(got - fp32) / np.linalg.norm(fp32) > 1e-3  # the int8 path ran


def _qconv_pair(seed, c=16, o=24):
    rng = np.random.default_rng(seed)
    gn = tl.GroupNormAct(c, act="swish", quant="out")
    conv = tl.QConv(c, o)
    with torch.no_grad():
        gn.weight.copy_(_t(1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)))
        gn.bias.copy_(_t(0.1 * rng.standard_normal(c).astype(np.float32)))
        conv.weight.copy_(_t((rng.standard_normal((o, c, 3, 3)) / 12).astype(np.float32)))
        conv.bias.copy_(_t(0.05 * rng.standard_normal(o).astype(np.float32)))
    return gn, conv


def test_qconv_module_prepares_its_weight_once_and_again_after_a_change(monkeypatch):
    calls = []
    real = tqc.prepare_s8_weight
    monkeypatch.setattr(tqc, "prepare_s8_weight",
                        lambda w, u=None: calls.append(1) or real(w, u))
    gn, conv = _qconv_pair(20)
    x = nhwc_to_nchw(np.random.default_rng(21).standard_normal((2, 6, 10, 16)).astype(np.float32))
    with torch.no_grad():
        first = [conv(*gn(x)) for _ in range(3)]
        assert len(calls) == 1
        conv.load_state_dict(_qconv_pair(22)[1].state_dict())
        after = conv(*gn(x))
        assert len(calls) == 2
        q, u = gn(x)
        want = tqc.qconv2d_prequant(q, u.clone(), conv.weight) + conv.bias[None, :, None, None]
    for out in first[1:]:
        torch.testing.assert_close(out, first[0], rtol=0, atol=0)
    assert not torch.equal(after, first[0])
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_qconv_module_dynamic_path_and_gate_match_jax():
    """QConv without a producer's scale: per-sample dynamic quantization
    where min(C, O) reaches min_channels, else the exact conv; use_tpu's
    QConv on the same params."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    for min_channels, quantized in ((16, True), (17, False)):
        jconv = jqc.QConv(24, (3, 3), padding=1, min_channels=min_channels)
        params = random_params(jax.eval_shape(jconv.init, jax.random.PRNGKey(0), x)["params"],
                               seed=10)
        want = np.asarray(jconv.apply({"params": params}, x))
        tconv = tl.QConv(16, 24, min_channels=min_channels)
        tconv.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
        with torch.no_grad():
            got = tconv(nhwc_to_nchw(x))
            exact = torch.nn.functional.conv2d(nhwc_to_nchw(x), tconv.weight, tconv.bias,
                                               padding=1)
        assert_close(nchw_to_nhwc(got), want, OP_RTOL, OP_ATOL)
        assert (float((got - exact).abs().max()) > 1e-4) == quantized


def test_ncsnpp_int8_state_dict_is_the_fp32_one():
    net = TNCSNpp(TConfig(**TINY))
    qnet = TNCSNpp(TConfig(**TINY, quant="int8", quant_min_channels=16))
    assert any(isinstance(m, tl.QConv) for m in qnet.modules())
    assert {k: v.shape for k, v in qnet.state_dict().items()} == {
        k: v.shape for k, v in net.state_dict().items()}


def _count_kernel_calls(monkeypatch):
    """Counts each kernel wrapper's calls by the CPU dispatch under it (the
    GroupNorm fold counts as a statistics launch, as on the card)."""
    from use_tpu_torch.ops import fused_skip

    counts = dict.fromkeys(("channel_sums", "gn_apply", "fused_skip_add", "qconv3x3_fused",
                            "gn_apply_int8", "qconv3x3_s8"), 0)

    def counting(owner, attr, name):
        real = getattr(owner, attr)

        def run(*args, **kw):
            counts[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(owner, attr, run)

    counting(tg, "_channel_sums_fwd", "channel_sums")
    counting(tl, "gn_fold", "channel_sums")
    counting(tg, "_gn_apply_fwd", "gn_apply")
    counting(tl, "gn_apply_int8", "gn_apply_int8")
    counting(fused_skip, "_fused_skip_add_fwd", "fused_skip_add")
    counting(tqc, "s8_conv", "qconv3x3_s8")
    return counts


def test_int8conv_launch_constants_of_chip_smoke(monkeypatch):
    """chip_smoke's PER_FORWARD["int8conv_bfloat16"]: each kernel's calls in
    one forward of the int8 ncsnpplarge, counted here on a 64 x 64 input
    (the counts follow the structure, not the size)."""
    import chip_smoke
    from use_tpu_torch.models import BackboneRegistry

    counts = _count_kernel_calls(monkeypatch)
    net = BackboneRegistry.get_by_name("ncsnpplarge")(input_channels=4, dtype="bfloat16",
                                                      quant="int8")
    with torch.inference_mode():
        net(torch.zeros((1, 64, 64, 4)), torch.tensor([0.5]))
    assert counts == chip_smoke.PER_FORWARD["int8conv_bfloat16"] == {
        "channel_sums": 106, "gn_apply": 20, "fused_skip_add": 34, "qconv3x3_fused": 0,
        "gn_apply_int8": 86, "qconv3x3_s8": 98}
