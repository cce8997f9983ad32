"""The int8 conv's operand layout, C32, and the s8 kernel's weight layout.

C32 is int8 [B, ceil(C/32), 2, *spatial, 16]: channel 32 k + 16 h + j of a
position at [b, k, h, ..., j], zeros past C (ops/qconv.py ``pack_c32``). K1's
int8 apply writes it on the card; on the CPU its plain version packs the
NCHW result. Everything here is integer bookkeeping, so every check is exact.
"""
import numpy as np
import pytest
import torch

from use_tpu_torch.ops import gn_stats as tg
from use_tpu_torch.ops import qconv as tqc


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("shape", [(2, 36, 5, 7), (1, 64, 3, 4), (2, 20, 11)],
                         ids=["ragged", "two_chunks", "rows"])
def test_pack_c32_against_a_naive_loop(shape):
    q = _int8(np.random.default_rng(0), shape)
    b, c, *spatial = shape
    nk = -(-c // 32)
    want = np.zeros((b, nk, 2, *spatial, 16), np.int8)
    for bi in range(b):
        for ch in range(c):
            want[bi, ch // 32, (ch % 32) // 16, ..., ch % 16] = q[bi, ch].numpy()
    packed = tqc.pack_c32(q)
    assert packed.is_contiguous() and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), want)  # zeros past C included
    assert tqc.is_c32(packed, c) and not tqc.is_c32(packed, c + 32)
    assert torch.equal(tqc.unpack_c32(packed, c), q)


@pytest.mark.parametrize("act", ["swish", None])
def test_gn_apply_int8_c32_is_the_packed_plain_result(act):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 36, 30)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 36)).astype(np.float32))
    off = torch.from_numpy(rng.standard_normal((2, 36)).astype(np.float32))
    u = torch.from_numpy((0.01 + 0.02 * rng.random(36)).astype(np.float32))
    got = tg.gn_apply_int8(x, a, off, u, act, torch.bfloat16, c32=True)
    nchw = tg.gn_apply_int8_plain(x, a, off, u, act, torch.bfloat16)
    assert got.shape == (2, 2, 2, 30, 16)
    assert torch.equal(got, tqc.pack_c32(nchw))
    assert torch.equal(tg.gn_apply_int8(x, a, off, u, act, torch.bfloat16), nchw)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_s8_conv_takes_c32_as_nchw(out_dtype):
    rng = np.random.default_rng(2)
    qx = _int8(rng, (2, 36, 5, 7))
    weight = torch.from_numpy((0.1 * rng.standard_normal((40, 36, 3, 3))).astype(np.float32))
    u = torch.from_numpy((0.01 + 0.02 * rng.random(36)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    prepared = tqc.prepare_s8_weight(weight, u)
    post = torch.tensor([0.5, 2.0])
    want = tqc.s8_conv(qx, prepared, post, bias, out_dtype)
    got = tqc.s8_conv(tqc.pack_c32(qx), prepared, post, bias, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="for weights"):
        tqc.s8_conv(tqc.pack_c32(qx)[:, :1], prepared)


def test_s8_weight_layout_against_a_naive_loop():
    """[ceil(O/128), ceil(C/32), 2, 9, 128, 16]: a block of 128 output
    channels and a chunk of 32 input channels is one contiguous image of a
    stage's weights, half, tap, output channel, 16 input channels; zeros
    past O and C."""
    o, c = 130, 36
    qw = _int8(np.random.default_rng(3), (o, c, 3, 3))
    got = tqc._s8_weights(qw).numpy()
    want = np.zeros((2, 2, 2, 9, 128, 16), np.int8)
    for oi in range(o):
        for ci in range(c):
            for tap in range(9):
                want[oi // 128, ci // 32, (ci % 32) // 16, tap, oi % 128, ci % 16] = \
                    qw[oi, ci, tap // 3, tap % 3]
    np.testing.assert_array_equal(got, want)
    prepared = tqc.prepare_s8_weight(qw.float())
    assert prepared.qk.shape == (2, 2, 2, 9, 128, 16) and prepared.qk.is_contiguous()


@pytest.mark.parametrize("w,tile", [(192, "16x16x128"), (24, "16x16x128"), (12, "16x8x128"),
                                    (3, "16x8x128")])
def test_pick_tile_by_width(w, tile):
    assert tqc.pick_tile(w) == tile and tile in tqc.TILES

