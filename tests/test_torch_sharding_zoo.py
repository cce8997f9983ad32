"""The 'model' axis of use_tpu_torch on the zoo's nets (parallel/sharding.py:
their plain convs cut in place, transposed convs on their output axis,
dim 1) against use_tpu's parallel/sharding.py, on the CPU.

- The rule: params_shardings names, through convert_jax's naming, exactly
  the leaves use_tpu's rule shards on the HiFi-GAN generator, the BWE
  generator, GaGNet, ConvTasNet and the NCSNv1 blocks (the port on the
  meta device, use_tpu through jax.eval_shape), at their default widths
  and the rule's default min_size, and tiny at a small one.
- The passes: four gloo ranks at (data=2, model=2)
  (tests/helpers/torch_tp_worker.py, kind ``zoo``) run each tiny net cut
  at its min_size on use_tpu's random params: every output and the
  inputs' gradients of their sum against use_tpu's apply over
  shard_params'd params on the 8-device CPU mesh at (2, 2), within 1e-5 of
  their largest |value| plus rtol 1e-4 (tests/test_torch_csmgan.py's, as
  tests/test_torch_sharding_gan.py holds the WaveDiscriminator); GaGNet
  within 1e-3 of its largest, tests/test_torch_gagnet.py's tolerance.
- A transposed conv cut against the uncut one (strides, the causal trim of
  HiFi-GAN's ConvTranspose1dC, a 2-D one as GaGNet's decoder has), cut on
  dim 1: the output and the input's gradient within 1e-6 of their largest
  (the same arithmetic in other shapes).
- Shard then gather returns use_tpu's params converted, bit for bit, and
  ConvTasNet's decoder (one output channel) stays whole, as use_tpu's
  divisibility fallback keeps it.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, random_params
from tests.test_torch_sharding import _launch_ranks
from use_tpu.models.convtasnet import ConvTasNet as JConvTasNet
from use_tpu.models.gagnet import GaGNet as JGaGNet
from use_tpu.models.gan import hifigan_bwe as jbwe, hifigan_vocoder as jvoc
from use_tpu.models.ncsnpp import legacy_layers as jl
from use_tpu.parallel import mesh as jmesh
from use_tpu.parallel import sharding as jsharding
from use_tpu_torch.engine import convert_jax
from use_tpu_torch.models import convtasnet as tct, gagnet as tgag
from use_tpu_torch.models.gan import hifigan_bwe as tbwe, hifigan_vocoder as tvoc
from use_tpu_torch.parallel import mesh as tmesh
from use_tpu_torch.parallel import sharding as tsharding

VOC = dict(in_channels=8, channels=16, upsample_scales=(4, 2), upsample_kernel_sizes=(8, 4),
           resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3), (1, 2)))
GAG = dict(c=8, cd1=8, d_feat=32, is_u2=True, causal=True, acti_type="sigmoid",
           intra_connect="cat", p=1, q=2, dilas=(1, 2))
GAG_F, GAG_T = 161, 7
TASNET = dict(fs=8000, enc_dim=16, feature_dim=8, layer=3, stack=2)
MIN_SIZE = 32  # every conv whose output axis divides by 2 is cut
BWE_MIN_SIZE = 1 << 10  # the WaveNet layers' convs; its 128-channel ends stay whole
# GaGNet's random tiny nets amplify fp32 rounding (instance norms over a few
# frames, random PReLU slopes): tests/test_torch_gagnet.py holds the uncut
# port to use_tpu at 1e-3 of the largest |value|, and so is the cut one
GAG_TOL = 1e-3
TRANSPOSED = {  # name: (port kwargs, input shape)
    "conv_transpose1d": (dict(in_channels=6, out_channels=8, kernel_size=5, stride=3), (2, 6, 7)),
    "conv_transpose_c": (dict(in_channels=6, features=8, kernel_size=8, stride=4, causal=True),
                         (2, 6, 7)),
    "conv_transpose2d": (dict(in_channels=6, out_channels=8, kernel_size=(1, 3), stride=(1, 2)),
                         (2, 6, 5, 7)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def _zoo():
    """name: (use_tpu's module, its inputs, its extra arguments, whether it
    takes the inputs as one list, the port's (net, kwargs) for the worker,
    the port's inputs, extra arguments, the converter, min_size, and the
    maps of use_tpu's outputs and of its inputs' gradients into the port's
    layout)."""
    ident = np.asarray
    refine_xs = [_x(9, (2, 8, 10, 8)), _x(10, (2, 4, 5, 16))]
    voc_x = _x(10, (2, 13, VOC["in_channels"]), 1.0)
    flax = convert_jax.flax_params_to_state_dict
    return {
        "hifigan": (jvoc.HifiganGenerator(**VOC), [voc_x], (), False, ("hifigan", VOC),
                    [_nchw(voc_x)], (), convert_jax.hifigan_generator_params_to_state_dict,
                    MIN_SIZE, (ident, _nchw)),
        "bwe": (jbwe.BandwidthExtender(), [_x(15, (1, 960))], (24000,), False, ("bwe", {}),
                [_x(15, (1, 960))], (24000,), convert_jax.bwe_params_to_state_dict,
                BWE_MIN_SIZE, (ident, ident)),
        "gagnet": (JGaGNet(**GAG), [_x(3, (2, GAG_F, GAG_T, 2), 0.5)], (), False,
                   ("gagnet", {"net": GAG, "freqs": GAG_F}),
                   [_x(3, (2, GAG_F, GAG_T, 2), 0.5)], (), flax, MIN_SIZE, (ident, ident)),
        "convtasnet": (JConvTasNet(**TASNET), [_x(1603, (2, 1603))], (), False,
                       ("convtasnet", TASNET), [_x(1603, (2, 1603))], (),
                       convert_jax.convtasnet_params_to_state_dict, MIN_SIZE, (ident, ident)),
        "refine": (jl.RefineBlock(8, (8, 16)), refine_xs, ((8, 10),), True,
                   ("refine", {"in_planes": (8, 16), "features": 8}),
                   [_nchw(a) for a in refine_xs], ((8, 10),), flax, MIN_SIZE, (_nchw, _nchw)),
        "residual_down": (jl.ResidualBlock(12, "down"), [_x(16, (2, 8, 10, 8))], (), False,
                          ("residual", {"input_dim": 8, "output_dim": 12, "resample": "down"}),
                          [_nchw(_x(16, (2, 8, 10, 8)))], (), flax, MIN_SIZE, (_nchw, _nchw)),
        "residual_dilated": (jl.ResidualBlock(12, None, dilation=2), [_x(17, (2, 8, 10, 8))],
                             (), False, ("residual", {"input_dim": 8, "output_dim": 12,
                                                      "dilation": 2}),
                             [_nchw(_x(17, (2, 8, 10, 8)))], (), flax, MIN_SIZE, (_nchw, _nchw)),
        "upsample_conv": (jl.UpsampleConv(6), [_x(14, (2, 6, 8, 4))], (), False,
                          ("upsample_conv", {"input_dim": 4, "output_dim": 6}),
                          [_nchw(_x(14, (2, 6, 8, 4)))], (), flax, MIN_SIZE, (_nchw, _nchw)),
    }


def _jax_params(jmod, inputs, extra, listed, seed):
    xs = [jnp.asarray(a) for a in inputs]
    args = (xs,) if listed else tuple(xs)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, *extra))["params"]
    return random_params(shapes, seed=seed)


def _jax_sharded(params, convert, min_size):
    """The port names of the leaves use_tpu's rule shards at model 2."""
    mesh = jmesh.make_mesh(model=2, devices=jax.devices()[:8])
    specs = jax.tree_util.tree_leaves(jsharding.params_shardings(params, mesh, min_size))
    out = set()
    for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(params)[0], specs):
        if s.spec == P():
            continue
        tree = node = {}
        for key in path[:-1]:
            node = node.setdefault(key.key, {})
        node[path[-1].key] = np.zeros(leaf.shape, np.float32)
        (name,) = convert(tree)
        out.add(name)
    return out


# -- the rule ---------------------------------------------------------------

def _full_size(name):
    """A zoo net at its default widths: use_tpu's params shapes, the port's
    net on the meta device, the converter."""
    def shapes(jmod, *args):
        return jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))["params"]

    with torch.device("meta"):
        if name == "hifigan":
            return (shapes(jvoc.HifiganGenerator(), jnp.zeros((1, 8, 80))), tvoc.HifiganGenerator(),
                    convert_jax.hifigan_generator_params_to_state_dict)
        if name == "bwe":
            return (shapes(jbwe.BandwidthExtender(), jnp.zeros((1, 960)), 24000),
                    tbwe.BandwidthExtender(), convert_jax.bwe_params_to_state_dict)
        if name == "gagnet":
            net = tgag.GaGNet()
            net.materialize(161)
            return (shapes(JGaGNet(), jnp.zeros((1, 161, 8, 2))), net,
                    convert_jax.flax_params_to_state_dict)
        return (shapes(JConvTasNet(), jnp.zeros((1, 1600))), tct.ConvTasNet(),
                convert_jax.convtasnet_params_to_state_dict)


def _cut(net, min_size):
    plan = tsharding.params_shardings(net, tmesh.make_mesh(model=2, world=8), min_size)
    return plan, {k for k, axis in plan.items() if axis is not None}


@pytest.mark.parametrize("name,count", [("hifigan", 35), ("bwe", 0), ("gagnet", 12),
                                        ("convtasnet", 72)])
def test_rule_matches_jax_at_default_widths(name, count):
    """Exactly use_tpu's leaves at the rule's default min_size, the
    transposed convs on dim 1."""
    params, net, convert = _full_size(name)
    plan, got = _cut(net, 1 << 16)
    assert got == _jax_sharded(params, convert, 1 << 16)
    assert len(got) == count
    for k in got:
        transposed = isinstance(net.get_submodule(k.rpartition(".")[0]),
                                torch.nn.modules.conv._ConvTransposeNd)
        assert plan[k] == (1 if transposed else 0)


@pytest.mark.parametrize("name", list(_zoo()))
def test_rule_matches_jax_on_the_tiny_nets(name):
    """Exactly use_tpu's leaves on the nets the ranks cut, at their
    min_size; ConvTasNet's decoder (one output channel) whole."""
    jmod, inputs, extra, listed, (net_name, kwargs), *_, convert, min_size, _ = _zoo()[name]
    params = _jax_params(jmod, inputs, extra, listed, seed=0)
    from tests.helpers.torch_tp_worker import _zoo_net

    net, _ = _zoo_net(net_name, kwargs)
    plan, got = _cut(net, min_size)
    assert got == _jax_sharded(params, convert, min_size) and got
    if name == "convtasnet":
        assert plan["decoder.weight"] is None


# -- four gloo ranks --------------------------------------------------------

def _transposed_setup(name, seed):
    kwargs, shape = TRANSPOSED[name]
    from tests.helpers.torch_tp_worker import _zoo_net

    net, _ = _zoo_net(name, kwargs)
    rng = np.random.default_rng(seed)
    state = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) / 3).astype(np.float32))
             for k, v in net.state_dict().items()}
    return net, state, _x(seed, shape, 1.0)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four port ranks on every case (started first, so that they run
    while use_tpu compiles), then use_tpu's sharded passes, the compiles
    overlapped in threads."""
    zoo = _zoo()
    cases, params = [], {}
    for i, (name, (jmod, inputs, extra, listed, (net, kwargs), t_inputs, t_extra, convert,
                   min_size, _)) in enumerate(zoo.items()):
        params[name] = _jax_params(jmod, inputs, extra, listed, seed=30 + i)
        cases.append(dict(kind="zoo", name=name, net=net, kwargs=kwargs, inputs=t_inputs,
                          extra=t_extra, state=convert(params[name]), min_size=min_size))
    transposed = {name: _transposed_setup(name, 40 + i) for i, name in enumerate(TRANSPOSED)}
    for name, (_, state, x) in transposed.items():
        cases.append(dict(kind="zoo", name=name, net=name, kwargs=TRANSPOSED[name][0],
                          inputs=[x], state=state, min_size=1))
    procs = _launch_ranks(tmp_path_factory.mktemp("tp_zoo"), {"cases": cases})
    try:
        mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])

        def jax_pass(name):
            jmod, inputs, extra, listed, *_, min_size, _ = zoo[name]

            def total(p, xs):
                y = (jmod.apply({"params": p}, xs, *extra) if listed
                     else jmod.apply({"params": p}, *xs, *extra))
                flat = list(y) if isinstance(y, (tuple, list)) else [y]
                return sum(v.sum() for v in flat), flat

            (_, outs), grads = jax.jit(jax.value_and_grad(total, argnums=1, has_aux=True))(
                jsharding.shard_params(params[name], mesh, min_size),
                [jnp.asarray(a) for a in inputs])
            return jax.device_get((outs, grads))

        with ThreadPoolExecutor(4) as pool:
            jobs = {name: pool.submit(jax_pass, name) for name in zoo}
            want = {name: job.result() for name, job in jobs.items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    tmp = os.path.dirname(procs[0].args[-1])
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    return outs, want, params, transposed


def _close(got, want, name):
    want = np.asarray(want)
    if name == "gagnet":  # tests/test_torch_gagnet.py's tolerance, and why
        assert_close(got, want, rtol=0, atol=GAG_TOL * float(np.abs(want).max()))
    else:
        assert_close(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(_zoo()))
def test_cut_zoo_net_matches_jax_sharded_apply(tp_run, name):
    """Every output and the inputs' gradients of their sum, on every rank,
    against use_tpu's apply over its sharded params."""
    outs, want, _, _ = tp_run
    out_layout, grad_layout = _zoo()[name][-1]
    w_outs, w_grads = want[name]
    for out in outs:
        got = out[name]
        assert got["sharded"]
        assert len(got["outputs"]) == len(w_outs)
        for g, w in zip(got["outputs"], w_outs):
            _close(g, out_layout(w), name)
        for g, w in zip(got["x_grads"], w_grads):
            _close(g, grad_layout(w), name)


def test_cut_nets_run_the_column_parallel_classes(tp_run):
    """The cut convs became column-parallel in place: the transposed ones
    of HiFi-GAN and GaGNet, the NCSNv1 layers' Conv (a subclass that
    keeps its init), the depthwise conv of ConvTasNet."""
    outs, _, _, _ = tp_run
    for out in outs:
        assert "ColumnParallelConvTranspose1d" in out["hifigan"]["classes"]
        assert {"ColumnParallelConvTranspose2d", "ColumnParallelConv2d"} <= set(
            out["gagnet"]["classes"])
        assert "ConvColumnParallel" in out["residual_down"]["classes"]
        assert "ColumnParallelConv1d" in out["convtasnet"]["classes"]
        assert any(k.endswith("Conv_1.weight") for k in out["convtasnet"]["sharded"])
        assert "decoder.weight" not in out["convtasnet"]["sharded"]


@pytest.mark.parametrize("name", list(TRANSPOSED))
def test_transposed_conv_cut_matches_the_uncut_one(tp_run, name):
    """Cut on dim 1 of [I, O, k...]: the output (after the causal trim for
    ConvTranspose1dC) and the input's gradient equal the uncut module's."""
    outs, _, _, transposed = tp_run
    net, state, x = transposed[name]
    net.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = net(xt)
    y.sum().backward()
    for out in outs:
        got = out[name]
        assert got["sharded"] and all(got["plan"][k] == 1 for k in got["sharded"])
        for g, w in ((got["outputs"][0], y.detach()), (got["x_grads"][0], xt.grad)):
            assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))


def test_shard_then_gather_round_trips(tp_run):
    """The gathered state of each cut net is use_tpu's params converted (or
    the given state), bit for bit, on every rank."""
    outs, _, params, transposed = tp_run
    zoo = _zoo()
    wants = {name: zoo[name][7](p) for name, p in params.items()}
    wants.update({name: state for name, (_, state, _) in transposed.items()})
    for out in outs:
        for name, want in wants.items():
            got = out[name]["gathered_before"]
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert torch.equal(got[k], v), (name, k)
