"""The NCSNv1 legacy layers and the normalization zoo in use_tpu_torch
against use_tpu's, on the CPU: every norm (the conditional ones with class
labels), the CRP / RCU / MSF / Refine blocks (conditional and not), the
pool-fused convs (ConvMeanPool with adjust_padding at k 1 and 3), the
nearest-upsampling conv, every branch of ResidualBlock, and the helpers
_pool5 (max and average, at the edges) and _bilinear_resize (to a
non-integer ratio).

Inputs drawn with numpy from a seed; use_tpu's NHWC arrays are NCHW here.
Weights are use_tpu's random params carried by engine/convert_jax.py (a
strict load). Tolerance: each output within 1e-5 of its largest |value|
(fp32; the frameworks sum convs in other orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import nchw_to_nhwc, nhwc_to_nchw, random_params
from use_tpu.models.ncsnpp import legacy_layers as jl, normalization as jn
from use_tpu_torch.engine.convert_jax import flax_params_to_state_dict
from use_tpu_torch.models.ncsnpp import legacy_layers as tl, normalization as tn

TOL = 1e-5
CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _labels(b):
    return np.arange(b, dtype=np.int32) * 3 % CLASSES


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _check(jmod, tmod, inputs, *extra, seed=0):
    """use_tpu's `jmod` on random params against the port's `tmod` with
    them, on NHWC `inputs` (one array or a list) and `extra` arguments
    (labels as int arrays, shapes as tuples)."""
    jx = [jnp.asarray(a) for a in inputs] if isinstance(inputs, list) else jnp.asarray(inputs)
    jextra = [jnp.asarray(e) if isinstance(e, np.ndarray) else e for e in extra]
    shapes = jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x, *jextra), jx)
    params = random_params(shapes["params"], seed=seed)
    want = np.asarray(jax.jit(lambda p, x: jmod.apply({"params": p}, x, *jextra))(params, jx))
    tmod.load_state_dict(flax_params_to_state_dict(params), strict=True)
    tx = ([nhwc_to_nchw(a) for a in inputs] if isinstance(inputs, list)
          else nhwc_to_nchw(inputs))
    textra = [torch.from_numpy(e).long() if isinstance(e, np.ndarray) else e for e in extra]
    with torch.no_grad():
        got = nchw_to_nhwc(tmod(tx, *textra))
    assert _rel(got, want) <= TOL


NORMS = [  # (name, conditional, kwargs, channels)
    ("instancenorm", False, {}, 8),
    ("batchnorm", False, {}, 8),
    ("groupnorm", False, {}, 64),
    ("variancenorm", False, {}, 8),
    ("variancenorm", True, {"num_classes": CLASSES}, 8),
    ("instancenorm++", False, {}, 8),
    ("instancenorm++", False, {"bias": False}, 8),
    ("instancenorm++", True, {"num_classes": CLASSES}, 8),
    ("instancenorm++", True, {"num_classes": CLASSES, "bias": False}, 8),
]


@pytest.mark.parametrize("name,conditional,kw,c", NORMS,
                         ids=[f"{n}{'-cond' if c else ''}{'-nobias' if 'bias' in k else ''}"
                              for n, c, k, _ in NORMS])
def test_norm_matches_jax(name, conditional, kw, c):
    x = 2.0 * _x(1, (4, 6, 5, c)) + 0.5
    extra = (_labels(4),) if conditional else ()
    jmod = jn.get_normalization(name, conditional)(**kw)
    tmod = tn.get_normalization(name, conditional)(c, **kw)
    _check(jmod, tmod, x, *extra, seed=2)


def test_get_normalization_refuses_unknown():
    for mod in (jn, tn):
        with pytest.raises(NotImplementedError):
            mod.get_normalization("groupnorm", True)


def test_conditional_norm_init():
    """The embeddings' rows 1 + 0.02 N(0, 1), the beta part zeros, as
    use_tpu initializes them; the same draws from the same generator."""
    a = tn.ConditionalInstanceNorm2dPlus(8, num_classes=CLASSES)
    tn.reset_parameters(a, torch.Generator().manual_seed(0))
    w = a.Embed_0.weight.detach()
    assert w.shape == (CLASSES, 24)
    assert torch.all(w[:, 16:] == 0)
    assert 0.005 < float((w[:, :16] - 1).std()) < 0.04
    b = tn.ConditionalInstanceNorm2dPlus(8, num_classes=CLASSES)
    tn.reset_parameters(b, torch.Generator().manual_seed(0))
    assert torch.equal(w, b.Embed_0.weight)


@pytest.mark.parametrize("maxpool", [True, False], ids=["max", "avg"])
def test_pool5_at_the_edges(maxpool):
    """5x5 SAME pooling on a 3 x 4 map, where every window runs past an edge:
    max pads with -inf (negative inputs stay negative), avg divides by 25."""
    x = -1.0 - np.abs(_x(3, (2, 3, 4, 2)))
    want = np.asarray(jl._pool5(jnp.asarray(x), maxpool))
    got = nchw_to_nhwc(tl._pool5(nhwc_to_nchw(x), maxpool))
    assert _rel(got, want) <= 1e-6
    assert (got < 0).all()


def test_bilinear_resize_non_integer_ratio():
    x = _x(4, (2, 5, 7, 3))
    want = np.asarray(jl._bilinear_resize(jnp.asarray(x), (8, 11)))
    got = nchw_to_nhwc(tl._bilinear_resize(nhwc_to_nchw(x), (8, 11)))
    assert _rel(got, want) <= 1e-6


def _cond(j):
    """A conditional InstanceNorm++ factory: use_tpu's and the port's."""
    if j:
        return functools.partial(jn.ConditionalInstanceNorm2dPlus, num_classes=CLASSES)
    return lambda c: tn.ConditionalInstanceNorm2dPlus(c, num_classes=CLASSES)


@pytest.mark.parametrize("variant", ["max", "avg", "conditional"])
def test_crp_block_matches_jax(variant):
    cond = variant == "conditional"
    jmod = jl.CRPBlock(8, 2, maxpool=variant == "max", normalizer=_cond(True) if cond else None)
    tmod = tl.CRPBlock(8, 2, maxpool=variant == "max", normalizer=_cond(False) if cond else None)
    _check(jmod, tmod, _x(5, (2, 6, 7, 8)), *((_labels(2),) if cond else ()), seed=6)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "conditional"])
def test_rcu_block_matches_jax(cond):
    jmod = jl.RCUBlock(8, 2, 2, normalizer=_cond(True) if cond else None)
    tmod = tl.RCUBlock(8, 2, 2, normalizer=_cond(False) if cond else None)
    _check(jmod, tmod, _x(7, (2, 6, 7, 8)), *((_labels(2),) if cond else ()), seed=8)


@pytest.mark.parametrize("inputs,cond,end", [(2, False, False), (2, True, True), (1, False, True)],
                         ids=["two", "two-conditional-end", "one-end"])
def test_refine_block_matches_jax(inputs, cond, end):
    """Two inputs of other widths and sizes go through MSF (a bilinear
    resize from 4 x 5 to 8 x 10); one input skips it."""
    planes = (8, 16)[:inputs]
    xs = [_x(9, (2, 8, 10, 8)), _x(10, (2, 4, 5, 16))][:inputs]
    extra = [(8, 10)] + ([_labels(2)] if cond else [])
    jmod = jl.RefineBlock(8, planes, end=end, normalizer=_cond(True) if cond else None)
    tmod = tl.RefineBlock(planes, 8, end=end, normalizer=_cond(False) if cond else None)
    _check(jmod, tmod, xs, *extra, seed=11)


@pytest.mark.parametrize("k,adjust,hw", [(3, False, (8, 10)), (1, False, (8, 10)),
                                         (3, True, (7, 9)), (1, True, (7, 9))],
                         ids=["k3", "k1", "k3-adjust", "k1-adjust"])
def test_conv_mean_pool_matches_jax(k, adjust, hw):
    _check(jl.ConvMeanPool(6, k, adjust_padding=adjust),
           tl.ConvMeanPool(4, 6, k, adjust_padding=adjust), _x(12, (2, *hw, 4)), seed=13)


@pytest.mark.parametrize("cls", ["MeanPoolConv", "UpsampleConv"])
def test_pool_and_upsample_convs_match_jax(cls):
    _check(getattr(jl, cls)(6), getattr(tl, cls)(4, 6), _x(14, (2, 6, 8, 4)), seed=15)


RESIDUAL = [  # (resample, input_dim, output_dim, dilation, adjust_padding, hw, conditional)
    (None, 8, 8, 1, False, (8, 10), False),  # identity shortcut
    (None, 8, 12, 1, False, (8, 10), False),  # 1x1 shortcut
    (None, 8, 12, 2, False, (8, 10), True),  # dilated, 3x3 shortcut, conditional
    (None, 8, 8, 2, False, (8, 10), False),  # dilated, identity shortcut
    ("down", 8, 12, 1, False, (8, 10), True),  # mean-pooled, conditional
    ("down", 8, 12, 2, False, (8, 10), False),  # dilated 'down': no pooling
]


@pytest.mark.parametrize("resample,cin,cout,dil,adjust,hw,cond", RESIDUAL,
                         ids=[f"{r or 'none'}-{i}to{o}-d{d}{'-adjust' if a else ''}"
                              f"{'-cond' if c else ''}" for r, i, o, d, a, _, c in RESIDUAL])
def test_residual_block_matches_jax(resample, cin, cout, dil, adjust, hw, cond):
    jmod = jl.ResidualBlock(cout, resample, normalizer=_cond(True) if cond else None,
                            dilation=dil, adjust_padding=adjust)
    tmod = tl.ResidualBlock(cin, cout, resample, normalizer=_cond(False) if cond else None,
                            dilation=dil, adjust_padding=adjust)
    assert (tmod.shortcut is None) == (resample is None and cin == cout)
    _check(jmod, tmod, _x(16, (2, *hw, cin)), *((_labels(2),) if cond else ()), seed=17)


def test_residual_down_with_adjust_padding_fails_as_use_tpu():
    """adjust_padding in a 'down' block: the 3x3 ConvMeanPool (VALID after
    the pad) and the 1x1 one (no padding) end one row apart, so the sum
    fails on shapes in both packages."""
    x = _x(16, (2, 7, 9, 8))
    jmod = jl.ResidualBlock(12, "down", adjust_padding=True)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x), jnp.asarray(x))
    with pytest.raises(RuntimeError):
        tl.ResidualBlock(8, 12, "down", adjust_padding=True)(nhwc_to_nchw(x))


def test_reset_parameters_is_seeded():
    """Every conv and norm of a block redrawn from a generator: the NCSNv1
    3x3 convs with the DDPM init (bounded by sqrt(3 / fan_avg)), the same
    weights for the same seed."""
    def make():
        block = tl.ResidualBlock(8, 12, "down", normalizer=_cond(False))
        tl.reset_parameters(block, torch.Generator().manual_seed(4))
        return block

    a, b = make(), make()
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    bound = np.sqrt(3.0 / ((8 * 9 + 8 * 9) / 2))
    assert float(a.conv1.weight.detach().abs().max()) <= bound
