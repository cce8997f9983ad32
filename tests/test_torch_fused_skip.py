"""Fused resblock shortcut (kernel K2) parity: the port's plain version
against use_tpu's Pallas kernel run in interpret mode on the CPU and against
its XLA formulation reference_skip_add. fp32 atol 1e-5; bf16 atol 0.05."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import nchw_to_nhwc, nhwc_to_nchw
from use_tpu.ops import pallas_skip as ps
from use_tpu_torch.ops.fused_skip import fused_skip_add, fused_skip_add_plain


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_xla(dtype, monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 32, 64)).astype(np.float32)  # NHWC, Ci 64
    h = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)  # Co 32
    w = (0.1 * rng.standard_normal((64, 32))).astype(np.float32)  # [Ci, Co]
    b = (0.1 * rng.standard_normal((32,))).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # round the inputs to the working dtype once, so both sides see the same values
    xj, hj, wj, bj = (jnp.asarray(a, jdt) for a in (x, h, w, b))
    x, h, w, b = (np.array(a, np.float32) for a in (xj, hj, wj, bj))

    monkeypatch.setattr(ps.pl, "pallas_call", functools.partial(ps.pl.pallas_call, interpret=True))
    scale = 2 ** -0.5
    want_pallas = np.asarray(ps.fused_skip_add(xj, hj, wj, bj, scale=scale, tile_h=2), np.float32)
    want_xla = np.asarray(ps.reference_skip_add(xj, hj, wj, bj, scale=scale), np.float32)

    got = fused_skip_add(nhwc_to_nchw(x).to(tdt), nhwc_to_nchw(h).to(tdt),
                         torch.from_numpy(w.T.copy()).to(tdt), torch.from_numpy(b).to(tdt), scale)
    assert got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(nchw_to_nhwc(got), want_pallas, atol=atol)
    np.testing.assert_allclose(nchw_to_nhwc(got), want_xla, atol=atol)


def test_plain_accepts_conv_weight_and_rejects_bad_shapes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 8, 3, 5)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((1, 4, 3, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.zeros(4)
    ref = torch.nn.functional.conv2d(x, w[:, :, None, None], b) + h
    torch.testing.assert_close(fused_skip_add_plain(x, h, w[:, :, None, None], b), ref,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        fused_skip_add(x, h, w.T.contiguous(), b)
    with pytest.raises(ValueError):
        fused_skip_add(x.to("meta"), h.to("meta"), w.to("meta"), b.to("meta"))



TINY = dict(nf=16, ch_mult=(1, 2, 2))


def _tiny_net(dtype, quant="none"):
    """A tiny NCSN++ with seeded weights; its BigGAN blocks that change their
    channel count or resample run the K2 shortcut."""
    from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp, NCSNppConfig

    torch.manual_seed(0)
    net = NCSNpp(NCSNppConfig(**TINY, dtype=dtype, quant=quant, quant_min_channels=16)).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.1 * torch.randn(p.shape))
    return net


def _tiny_forward(net):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 32, 16, 4)).astype(np.float32))
    with torch.no_grad():
        return net(x, torch.full((1,), 0.5))


def _shortcuts(net):
    from use_tpu_torch.models.ncsnpp.layers import ResnetBlockBigGANpp

    return [m.Conv_2 for m in net.modules()
            if isinstance(m, ResnetBlockBigGANpp) and m.Conv_2 is not None]


def test_cast_backbone_casts_shortcut_weight_and_bias():
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    net = _tiny_net("bfloat16")
    cast_backbone_for_inference(net)
    convs = _shortcuts(net)
    assert convs
    for conv in convs:
        assert conv.weight.dtype == conv.bias.dtype == torch.bfloat16
    shortcut = {id(t) for conv in convs for t in (conv.weight, conv.bias)}
    for name, p in net.named_parameters():
        if id(p) not in shortcut and ("GroupNorm" in name or p.dim() <= 1):
            assert p.dtype == torch.float32, name


@pytest.mark.parametrize("quant", ["none", "int8_pallas"])
def test_shortcut_takes_cast_params_without_a_copy(quant, monkeypatch):
    """After the serving cast, K2 gets Conv_2's own bf16 weight and bias: no
    cast at any call."""
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    net = _tiny_net("bfloat16", quant)
    cast_backbone_for_inference(net)
    own = {t.data_ptr() for conv in _shortcuts(net) for t in (conv.weight, conv.bias)}
    seen = []

    def record(x, h, w, b, scale):
        seen.append((w.data_ptr() in own, b.data_ptr() in own, w.dtype, b.dtype))
        return fused_skip_add(x, h, w, b, scale)

    monkeypatch.setattr(layers, "fused_skip_add", record)
    _tiny_forward(net)
    assert len(seen) == len(_shortcuts(net))
    assert set(seen) == {(True, True, torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("quant", ["none", "int8_pallas"])
def test_cast_backbone_only_rounds_the_weights(quant):
    """The serving cast changes the forward only by rounding the weights it
    casts: a net holding the same rounded weights in fp32, cast by each layer
    at use, gives the same forward bit for bit (K2's bias included)."""
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    net = _tiny_net("bfloat16", quant)
    cast_backbone_for_inference(net)
    ref = _tiny_net("bfloat16", quant)
    rounded = 0
    with torch.no_grad():
        for p, q in zip(net.parameters(), ref.parameters()):
            if p.dtype == torch.bfloat16:
                q.copy_(p.float())
                rounded += 1
    assert rounded and all(q.dtype == torch.float32 for q in ref.parameters())
    torch.testing.assert_close(_tiny_forward(net), _tiny_forward(ref), rtol=0, atol=0)


def test_cast_backbone_leaves_fp32_alone():
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    net = _tiny_net("float32")
    kept = {name: (p, p.data_ptr()) for name, p in net.named_parameters()}
    cast_backbone_for_inference(net)
    for name, p in net.named_parameters():
        assert p is kept[name][0] and p.data_ptr() == kept[name][1]
        assert p.dtype == torch.float32
