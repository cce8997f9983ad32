"""K3 parity: use_tpu_torch's fused GroupNorm-affine + SiLU + int8 3x3 conv,
its GroupNorm 'fold' mode, int8 BigGAN blocks and the int8 U-Net against
use_tpu's, with inputs and weights drawn with numpy from a seed.

On the JAX side the Pallas kernel runs as tests/test_pallas_qconv.py runs it
(interpret mode on the CPU) or through its lax oracle ``qconv3x3_reference``;
the blocks and the U-Net take the oracle (monkeypatched into use_tpu for the
test only), which is bit-exact to the kernel up to the final cast. On the
port's side the wrapper takes its plain version on CPU tensors.

Tolerances: the op itself is exact integer arithmetic around f32 roundings
that both sides do in the same order, so it matches to rtol 1e-6 / atol 1e-5
(use_tpu's own test); no quantum flips at these seeds, and none is allowed.
Blocks: rtol 1e-4 / atol 1e-5, the fp32 block tolerance of
test_torch_ncsnpp.py; the GroupNorm sums run in another order, which could
flip a quantum, but flips none at these seeds, and none is allowed. The
U-Net: a last-bit difference of the GroupNorm statistics somewhere flips one
quantum, and the flip spreads through the following blocks, so the
end-to-end output is held only to a relative L2 of 0.05 (readings 0 to 0.027
on seeds 6-10; the same U-Net with the edge mask broken reads 0.13-0.26).
What is exact there is checked exactly: every fused conv call in the same
order, with the same shapes, int8 weights and activation scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, random_params,
)
from use_tpu.models.ncsnpp import layers as jl
from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
from use_tpu.ops import pallas_qconv as jq
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp import layers as tl
from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as TNCSNpp, NCSNppConfig as TConfig
from use_tpu_torch.ops import fused_qconv as tq

OP_RTOL, OP_ATOL = 1e-6, 1e-5
BLOCK_RTOL, BLOCK_ATOL = 1e-4, 1e-5
MODEL_REL_L2 = 0.05


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hwio_to_oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _op_inputs(B, H, W, C, O, seed, affine):
    """As tests/test_pallas_qconv.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C, O)) * 0.1).astype(np.float32)
    u = (0.02 + 0.01 * rng.random(C)).astype(np.float32)
    if not affine:
        return x, k, u, None, None, None
    a = (1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32)
    o = (0.1 * rng.standard_normal((B, C))).astype(np.float32)
    bias = (0.05 * rng.standard_normal(O)).astype(np.float32)
    return x, k, u, a, o, bias


def test_quantize_weight_folded_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((3, 3, 128, 64)) * 0.1).astype(np.float32)
    u = (0.02 + 0.01 * rng.random(128)).astype(np.float32)
    qw, sw = jq._quantize_weight_folded(jnp.asarray(k), jnp.asarray(u))
    tqw, tsw = tq.quantize_weight_folded(_hwio_to_oihw(k), _t(u))
    assert tqw.dtype == torch.int8 and tqw.shape == (64, 128, 3, 3)
    np.testing.assert_array_equal(tqw.numpy().transpose(2, 3, 1, 0).reshape(9 * 128, 64),
                                  np.asarray(qw))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))
    _assert_kernel_layout(tq._weights_for_kernel(tqw), np.asarray(qw).reshape(9, 128, 64))


def _assert_kernel_layout(wk, want):
    """wk, the kernel's int8 [ceil(C / 32), 2, 9, O, 16], unpacked by a naive
    index loop, equals want [9, C, O] (use_tpu's HWIO order); zeros past C."""
    taps, c, o = want.shape
    wk = wk.numpy()
    assert wk.dtype == np.int8 and wk.shape == (-(-c // 32), 2, 9, o, 16)
    got = np.full((9, c, o), 99, np.int8)
    for k in range(wk.shape[0]):
        for half in range(2):
            for tap in range(9):
                for oo in range(o):
                    for j in range(16):
                        if 32 * k + 16 * half + j < c:
                            got[tap, 32 * k + 16 * half + j, oo] = wk[k, half, tap, oo, j]
                        else:
                            assert wk[k, half, tap, oo, j] == 0
    np.testing.assert_array_equal(got, want)


def test_kernel_weight_layout_ragged_channels_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((3, 3, 36, 40)) * 0.1).astype(np.float32)
    u = (0.02 + 0.01 * rng.random(36)).astype(np.float32)
    qw, _ = jq._quantize_weight_folded(jnp.asarray(k), jnp.asarray(u))
    prepared = tq.prepare_qconv_weight(_hwio_to_oihw(k), _t(u))
    _assert_kernel_layout(prepared.qw, np.asarray(qw).reshape(9, 36, 40))
    tqw, _ = tq.quantize_weight_folded(_hwio_to_oihw(k), _t(u))
    assert torch.equal(tq._weights_from_kernel(prepared.qw, 36), tqw)


@pytest.mark.parametrize("b,h,w,o,tile", [
    (8, 512, 192, 128, "16x16x128"), (8, 256, 96, 128, "16x16x128"),
    (8, 128, 48, 256, "8x16x256"), (8, 64, 24, 256, "8x16x256"), (8, 128, 16, 128, "16x16x128"),
    (8, 32, 12, 256, "8x8x256"), (8, 16, 6, 256, "8x8x256"), (8, 8, 3, 256, "8x8x256"),
    (1, 512, 64, 64, "16x16x64"), (1, 128, 16, 128, "8x8x256"),  # a model rank's slices
    (2, 5, 7, 40, "8x8x256"),
])
def test_pick_tile_at_the_int8_path_shapes(b, h, w, o, tile):
    assert tq.pick_tile(h, w, o, b) == tile and tile in tq.TILES


@pytest.mark.parametrize("shape,tile,splits", [
    ((8, 128, 128, 512, 192), "16x16x128", 1),  # 3072 tiles
    ((8, 256, 256, 64, 24), "8x16x256", 1),  # 128 tiles: no split
    ((1, 128, 64, 512, 64), "16x16x64", 1),  # a rank's O 64: 128 tiles
    ((1, 256, 128, 128, 16), "16x16x128", 8),  # 8 tiles, 8 chunks: one a unit
    ((8, 512, 256, 32, 12), "8x8x256", 2),  # 64 tiles
    ((8, 256, 256, 8, 3), "8x8x256", 8),  # 8 tiles
    ((2, 36, 40, 5, 7), "8x8x256", 2),  # 2 tiles, 2 chunks
])
def test_split_plan_fills_the_card(shape, tile, splits):
    """Tiles fewer than half of 132 SMs split their chunks over up to
    132 // tiles units; the workspace holds a tile's sums and a counter."""
    b, c, o, h, w = shape
    got, n = tq.split_plan(tile, b, c, h, w, o, 132)
    th, tw, bn = tq.tile_shape(tile)
    tiles = b * -(-h // th) * -(-w // tw) * -(-o // bn)
    assert got == splits and got <= -(-c // 32)
    assert n == (tiles * (th * tw * bn + 1) if splits > 1 else 0)


@pytest.mark.parametrize(
    "B,C,O,H,W,affine,dtype,seed",
    [(2, 128, 128, 8, 16, True, "float32", 11), (1, 36, 40, 5, 7, True, "float32", 12),
     (2, 64, 32, 4, 6, False, "bfloat16", 13)],
    ids=["fused_gn_act_bias", "ragged", "bf16_plain"],
)
def test_qconv3x3_prepared_equals_fused_and_plain(B, C, O, H, W, affine, dtype, seed):
    x, k, u, a, o, bias = _op_inputs(B, H, W, C, O, seed, affine)
    tx = nhwc_to_nchw(x).to(getattr(torch, dtype))
    w, tu = _hwio_to_oihw(k), _t(u)
    rest = (None if a is None else _t(a), None if o is None else _t(o), affine,
            None if bias is None else _t(bias), getattr(torch, dtype))
    prepared = tq.prepare_qconv_weight(w, tu)
    assert prepared.qw.shape == (-(-C // 32), 2, 9, O, 16) and prepared.sw.shape == (O,)
    launches = tq.qconv3x3_fused.launches
    got = tq.qconv3x3_fused_prepared(tx, prepared, *rest)
    assert tq.qconv3x3_fused.launches == launches  # CPU tensors: the plain version
    assert got.shape == (B, O, H, W) and got.dtype == getattr(torch, dtype)
    torch.testing.assert_close(got, tq.qconv3x3_fused(tx, w, tu, *rest), rtol=0, atol=0)
    torch.testing.assert_close(got, tq.qconv3x3_fused_plain(tx, w, tu, *rest), rtol=0, atol=0)
    torch.testing.assert_close(got, tq.qconv3x3_fused(tx, w, tu, *rest, prepared=prepared),
                               rtol=0, atol=0)


@pytest.mark.parametrize(
    "B,H,W,affine,dtype,seed",
    [(2, 8, 16, False, "float32", 0), (2, 8, 16, True, "float32", 1),
     (1, 4, 8, False, "float32", 2), (1, 16, 8, False, "float32", 3),
     (2, 8, 16, True, "bfloat16", 4)],
    ids=["plain", "fused_gn_act_bias", "edge_rows", "row_tiles", "bf16_x"],
)
def test_qconv3x3_matches_pallas_interpret_and_reference(B, H, W, affine, dtype, seed):
    x, k, u, a, o, bias = _op_inputs(B, H, W, 128, 128, seed, affine)
    jx = jnp.asarray(x).astype(dtype)
    jkw = dict(act=affine, out_dtype=jnp.float32)
    if affine:
        jkw.update(gn_scale=jnp.asarray(a), gn_shift=jnp.asarray(o), bias=jnp.asarray(bias))
    interp = np.asarray(jq.qconv3x3_fused(jx, jnp.asarray(k), jnp.asarray(u), tile_h=4,
                                          interpret=True, **jkw))
    ref = np.asarray(jq.qconv3x3_reference(jx, jnp.asarray(k), jnp.asarray(u), **jkw))

    tx = nhwc_to_nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    targs = (tx, _hwio_to_oihw(k), _t(u), None if a is None else _t(a),
             None if o is None else _t(o), affine, None if bias is None else _t(bias),
             torch.float32)
    plain = tq.qconv3x3_fused_plain(*targs)
    launches = tq.qconv3x3_fused.launches
    wrapped = tq.qconv3x3_fused(*targs)  # CPU tensors: the plain version, no launch
    assert tq.qconv3x3_fused.launches == launches
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=0)
    assert plain.shape == (B, 128, H, W) and plain.dtype == torch.float32
    assert_close(nchw_to_nhwc(plain), interp, OP_RTOL, OP_ATOL)
    assert_close(nchw_to_nhwc(plain), ref, OP_RTOL, OP_ATOL)


def test_edge_leak_control_differs_only_at_the_edges():
    """chip_smoke's broken control (x zero-padded before the affine) must
    differ from the plain version, and only in the border pixels."""
    x, k, u, a, o, bias = _op_inputs(1, 8, 16, 128, 128, 5, affine=True)
    args = (nhwc_to_nchw(x), _hwio_to_oihw(k), _t(u), _t(a), _t(o), True, _t(bias),
            torch.float32)
    diff = (tq.qconv3x3_edge_leak_plain(*args) - tq.qconv3x3_fused_plain(*args)).abs()
    assert float(diff[:, :, 1:-1, 1:-1].max()) == 0.0
    for edge in (diff[:, :, 0], diff[:, :, -1], diff[:, :, :, 0], diff[:, :, :, -1]):
        assert float(edge.max()) > 0.0


def test_groupnorm_fold_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 12, 64)).astype(np.float32)
    jgn = jl.GroupNormAct(64, act=jax.nn.silu, quant="fold")
    shapes = jax.eval_shape(jgn.init, jax.random.PRNGKey(0), x)["params"]
    params = random_params(shapes, seed=7)
    ja, joff, ju = (np.asarray(v) for v in jgn.apply({"params": params}, x))

    tgn = tl.GroupNormAct(64, act="swish", quant="fold")
    tgn.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        ta, toff, tu = tgn(nhwc_to_nchw(x))
    assert ta.shape == toff.shape == (2, 64) and tu.shape == (64,)
    assert ta.dtype == toff.dtype == tu.dtype == torch.float32
    assert_close(ta.numpy(), ja, 1e-5, 1e-6)  # sums in another order
    assert_close(toff.numpy(), joff, 1e-5, 1e-6)
    np.testing.assert_array_equal(tu.numpy(), ju)


@pytest.mark.parametrize(
    "in_ch,out_ch,up,down,qp0",
    [(16, 16, False, False, True), (16, 16, True, False, False),
     (16, 16, False, True, False), (16, 32, False, False, True)],
    ids=["plain", "up", "down", "channels"],
)
def test_int8_biggan_block_matches_jax(monkeypatch, in_ch, out_ch, up, down, qp0):
    monkeypatch.setattr(jq, "qconv3x3_fused", jq.qconv3x3_reference)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    kw = dict(up=up, down=down, fir=True, temb_dim=32, quant="int8_pallas", quant_min_channels=1)
    jblock = jl.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=out_ch, **kw)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, temb)["params"]
    params = random_params(shapes, seed=1)
    want = np.asarray(jblock.apply({"params": params}, x, temb))

    tblock = tl.ResnetBlockBigGANpp(act="swish", in_ch=in_ch, out_ch=out_ch, **kw)
    tblock.load_state_dict(ncsnpp_params_to_state_dict(params), strict=True)
    assert (tblock.qp0, tblock.qp1) == (qp0, True)
    assert isinstance(tblock.Conv_1, tl.FusedQConv3x3)
    with torch.no_grad():
        got = tblock.eval()(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(nchw_to_nhwc(got), want, BLOCK_RTOL, BLOCK_ATOL)


TINY = dict(nf=16, ch_mult=(1, 2, 2))
TINY_INT8 = dict(TINY, quant="int8_pallas", quant_min_channels=16)


def test_tiny_int8_ncsnpp_matches_jax(monkeypatch):
    jcalls, tcalls = [], []

    def jrecord(x, kernel, u, **kw):
        jcalls.append((np.asarray(x).shape, np.asarray(kernel), np.asarray(u)))
        return jq.qconv3x3_reference(x, kernel, u, **kw)

    real = tq.qconv3x3_fused

    def trecord(x, weight, u, *args, **kw):
        tcalls.append((tuple(x.permute(0, 2, 3, 1).shape),
                       weight.detach().numpy().transpose(2, 3, 1, 0), u.numpy()))
        return real(x, weight, u, *args, **kw)

    monkeypatch.setattr(jq, "qconv3x3_fused", jrecord)
    monkeypatch.setattr(tq, "qconv3x3_fused", trecord)
    x0 = np.zeros((1, 32, 64, 4), np.float32)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**TINY)).init, jax.random.PRNGKey(0), x0,
                            jnp.full((1,), 0.5))["params"]
    params = random_params(shapes, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 64, 4)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(JNCSNpp(JConfig(**TINY_INT8)).apply({"params": params}, x, t))

    state = ncsnpp_params_to_state_dict(params)
    net = TNCSNpp(TConfig(**TINY_INT8))
    net.load_state_dict(state, strict=True)
    fnet = TNCSNpp(TConfig(**TINY))
    fnet.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net(_t(x), _t(t)).numpy()
        fp32 = fnet(_t(x), _t(t)).numpy()

    n_fused = sum(isinstance(m, tl.FusedQConv3x3) for m in net.modules())
    assert n_fused == len(tcalls) == len(jcalls) == 26
    for (js, jk, ju), (ts, tk, tu) in zip(jcalls, tcalls):
        assert js == ts
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tu, ju)
    assert got.shape == want.shape == (2, 32, 64, 1, 2)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= MODEL_REL_L2, rel
    assert np.linalg.norm(got - fp32) / np.linalg.norm(fp32) > 1e-3  # the int8 path ran


def _fold_and_conv(seed, c=16, o=24):
    """GroupNormAct(quant='fold') feeding a FusedQConv3x3, parameters drawn
    with numpy from a seed."""
    rng = np.random.default_rng(seed)
    gn = tl.GroupNormAct(c, act="swish", quant="fold")
    conv = tl.FusedQConv3x3(c, o)
    with torch.no_grad():
        gn.weight.copy_(_t(1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)))
        gn.bias.copy_(_t(0.1 * rng.standard_normal(c).astype(np.float32)))
        conv.weight.copy_(_t((rng.standard_normal((o, c, 3, 3)) / 12).astype(np.float32)))
        conv.bias.copy_(_t(0.05 * rng.standard_normal(o).astype(np.float32)))
    return gn, conv


def _uncached(gn, conv, x):
    a, off, u = gn(x)
    return tq.qconv3x3_fused_plain(x, conv.weight, u.clone(), a, off, True, conv.bias, conv.dtype)


def test_fused_qconv_module_prepares_its_weight_once(monkeypatch):
    calls = []
    real = tq.quantize_weight_folded

    def counting(weight, u):
        calls.append(tuple(weight.shape))
        return real(weight, u)

    gn, conv = _fold_and_conv(20)
    x = nhwc_to_nchw(np.random.default_rng(21).standard_normal((2, 6, 10, 16)).astype(np.float32))
    with torch.no_grad():
        want = _uncached(gn, conv, x)
        monkeypatch.setattr(tq, "quantize_weight_folded", counting)
        outs = [conv(x, *gn(x)) for _ in range(3)]
        assert gn(x)[2] is gn(x)[2]  # one u tensor while the affine holds
    assert len(calls) == 1  # the first forward only
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=0)


def _set_conv_weight(gn, conv, seed):
    with torch.no_grad():
        conv.weight.copy_(_fold_and_conv(seed)[1].weight)


def _load_conv_state(gn, conv, seed):
    conv.load_state_dict(_fold_and_conv(seed)[1].state_dict())


def _set_gn_affine(gn, conv, seed):
    with torch.no_grad():
        gn.weight.mul_(1.5)


def _set_conv_bias(gn, conv, seed):
    with torch.no_grad():
        conv.bias.add_(0.25)


def _cast_conv_weight(gn, conv, seed):
    with torch.no_grad():
        conv.weight.data = conv.weight.data.to(torch.bfloat16)


@pytest.mark.parametrize(
    "change", [_load_conv_state, _set_conv_weight, _set_gn_affine, _set_conv_bias,
               _cast_conv_weight],
    ids=["load_state_dict", "weight_copy_", "gn_affine", "bias", "weight_cast"],
)
def test_fused_qconv_module_cache_rebuilds_after_a_change(monkeypatch, change):
    calls = []
    real = tq.quantize_weight_folded
    monkeypatch.setattr(tq, "quantize_weight_folded",
                        lambda weight, u: calls.append(1) or real(weight, u))
    gn, conv = _fold_and_conv(30)
    x = nhwc_to_nchw(np.random.default_rng(31).standard_normal((2, 6, 10, 16)).astype(np.float32))
    with torch.no_grad():
        before = conv(x, *gn(x))
        change(gn, conv, 32)
        n = len(calls)
        after = conv(x, *gn(x))
        assert len(calls) == n + 1  # quantized anew
        again = conv(x, *gn(x))
        assert len(calls) == n + 1
        want = _uncached(gn, conv, x)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)


def test_fused_qconv_module_built_in_inference_mode_follows_load_state_dict():
    """Inference tensors count no in-place updates, so nothing made from
    them is kept: a load_state_dict under inference mode still shows."""
    src = [_fold_and_conv(seed) for seed in (40, 41)]
    x = nhwc_to_nchw(np.random.default_rng(42).standard_normal((2, 6, 10, 16)).astype(np.float32))
    with torch.inference_mode():
        gn, conv = tl.GroupNormAct(16, act="swish", quant="fold"), tl.FusedQConv3x3(16, 24)
        for sgn, sconv in src:
            gn.load_state_dict(sgn.state_dict())
            conv.load_state_dict(sconv.state_dict())
            got = conv(x, *gn(x))
            torch.testing.assert_close(got, _uncached(sgn, sconv, x), rtol=0, atol=0)
