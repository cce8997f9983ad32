"""The 'model' axis of use_tpu_torch (parallel/sharding.py, make_mesh and
default_world's model argument in parallel/mesh.py) against use_tpu's
parallel/sharding.py and mesh, on the CPU.

- The rule: the port's params_shardings names, through convert_jax's
  naming, exactly the leaves use_tpu's shards: 19 on use_tpu's test net
  (min_size 1 << 8), 173 with 64,077,824 weights on SGMSE_Large (default
  min_size; the port on the meta device, use_tpu through jax.eval_shape);
  use_tpu's fallback cases on port modules; make_mesh's shapes; the
  default_world / default_mesh rule with model=2, its error text included.
- The step: four gloo ranks at (data=2, model=2)
  (tests/helpers/torch_tp_worker.py, port only) on the inputs of use_tpu's
  test_tensor_parallel_step_matches_data_parallel (its net, params, batch
  and key; the draws passed in), the port with remat conv_outs: the loss
  within rtol 1e-5 and the gathered parameters after the step within 1e-4
  of use_tpu's sharded step and of its data-parallel step (use_tpu's own
  tolerance, tests/test_parallel.py:131); the applied gradient, gathered,
  within _grads_close (tests/test_torch_gan_train.py) of use_tpu's over
  the batch; the same with a grad_clip that binds (optax's
  clip_by_global_norm); replicated parameters bit-identical on all four
  ranks, each slice across its data group; a gather whose backward sums,
  as torch.distributed.nn's all_gather does, fails these gates; shard
  then gather is bit-equal, and the gathered state serves from an
  unsharded net.
- The nets the port refused until transposed convs, the zoo's plain convs
  and the int8 convs were cut (HiFi-GAN's generator, ConvTasNet, a
  transposed conv, the int8 nets): the plan names use_tpu's leaves, each
  on its output axis (dim 1 of a transposed conv's weight).
- Refusals: shard_params raises, naming the parameter, on a conv that pads
  other than with zeros, a grouped transposed conv and a plain conv of a
  net that does not set shards_plain_convs.
"""
import os
import socket
import subprocess
import sys

import jax
import flax.linen as jnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.test_torch_gan_train import _grads_close
from tests.test_torch_train import jax_draws
from use_tpu.config.config import load_config as jload_config
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import TrainState as JTrainState
from use_tpu.engine.train import make_sgmse_train_step
from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel
from use_tpu.parallel import mesh as jmesh
from use_tpu.parallel import sharding as jsharding
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp import layers as tlayers
from use_tpu_torch.models.registry import BackboneRegistry
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel
from use_tpu_torch.parallel import mesh as tmesh
from use_tpu_torch.parallel import sharding as tsharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# use_tpu's test_tensor_parallel_step_matches_data_parallel (tests/test_parallel.py:89-131)
NET = dict(backbone="ncsnpp", condition="noisy", sde_input="noisy", n_fft=126, hop_length=32,
           num_frames=16)
NET_KWARGS = dict(nf=8, ch_mult=(1,), num_res_blocks=1)
MIN_SIZE = 1 << 8
LR = 1e-3
# the binding clip: about a fifth of the step's gradient norm, and small
# enough that the clipped gradients sit near Adam's eps, where the step
# depends on their scale (a norm that missed the other ranks' slices moves
# it by more than the 1e-4 gate)
CLIP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_name(path, ndim):
    """The port's state_dict name of use_tpu's NCSN++ param at `path`."""
    tree = node = {}
    for key in path[:-1]:
        node = node.setdefault(key.key, {})
    node[path[-1].key] = np.zeros((1,) * ndim, np.float32)
    (name,) = ncsnpp_params_to_state_dict(tree)
    return name


def _jax_sharded(params, model, min_size):
    """{port name: size} of the leaves use_tpu's rule shards."""
    devices = jax.devices()[:8]
    mesh = jmesh.make_mesh(model=model, devices=devices)
    specs = jsharding.params_shardings(params, mesh, min_size)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    shardings = jax.tree_util.tree_leaves(specs)
    return {_port_name(path, leaf.ndim): int(np.prod(leaf.shape))
            for (path, leaf), s in zip(leaves, shardings) if s.spec != P()}


def _port_sharded(net, model, min_size):
    sizes = {k: p.numel() for k, p in net.named_parameters()}
    plan = tsharding.params_shardings(net, tmesh.make_mesh(model=model, world=8), min_size)
    return {k: sizes[k] for k, axis in plan.items() if axis is not None}


def test_rule_matches_jax_on_its_test_net():
    jm = JScoreModel(**NET, backbone_kwargs=NET_KWARGS)
    params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = _jax_sharded(params, 2, MIN_SIZE)
    net = TScoreModel(**NET, backbone_kwargs=NET_KWARGS, device="cpu").score_net
    got = _port_sharded(net, 2, MIN_SIZE)
    assert got == want
    assert len(got) == 19
    kinds = [type(net.get_submodule(k.rpartition(".")[0])).__name__ for k in got]
    assert (kinds.count("Conv2d"), kinds.count("Linear")) == (12, 7)


def test_rule_matches_jax_on_sgmse_large():
    """173 leaves, 64,077,824 of the 64,799,782 weights, on the output
    axis, which divides by 4 wherever the rule shards."""
    cfg = jload_config("SGMSE_Large")["model"]
    jm = JScoreModel(**{k: v for k, v in cfg.items()})
    params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = _jax_sharded(params, 4, 1 << 16)
    with torch.device("meta"):
        net = BackboneRegistry.get_by_name(cfg["backbone"])(input_channels=4,
                                                            **cfg["backbone_kwargs"])
    got = _port_sharded(net, 4, 1 << 16)
    assert got == want
    assert len(got) == 173 and sum(got.values()) == 64_077_824
    assert sum(p.numel() for p in net.parameters()) == 64_799_782


class _Rules(torch.nn.Module):
    """use_tpu's test_param_sharding_rules tree as port modules, and the
    port's replicated kinds beside it."""

    def __init__(self):
        super().__init__()
        self.big = tlayers.Conv2d(128, 256)  # HWIO (3, 3, 128, 256)
        self.small = tlayers.Conv2d(4, 4, kernel=1)
        self.odd = tlayers.Conv2d(128, 255)  # not divisible
        self.dense = tlayers.Linear(64, 32)
        self.nin = tlayers.NIN(64, 64)
        self.fir = tlayers.Downsample(64, 64, with_conv=True, fir=True)
        self.norm = tlayers.GroupNormAct(64)


@pytest.mark.parametrize("name,axis", [
    ("big.weight", 0), ("big.bias", None), ("small.weight", None), ("small.bias", None),
    ("odd.weight", None), ("dense.weight", 0), ("dense.bias", None), ("nin.W", None),
    ("fir.Conv2d_0.weight", None), ("norm.weight", None)])
def test_param_sharding_rules(name, axis):
    """min_size 1 << 10 on a model axis of 2: the big kernel sharded on its
    output axis, the small one, biases, the NIN's W, the FIR conv (use_tpu's
    Conv2d_0_weight) and the norm replicated, the odd one fallen back."""
    plan = tsharding.params_shardings(_Rules(), tmesh.make_mesh(model=2, world=8), 1 << 10)
    assert plan[name] == axis


def test_make_mesh_shapes():
    assert tmesh.make_mesh(world=8).shape == {"data": 8, "model": 1}
    assert tmesh.make_mesh(model=2, world=8).shape == {"data": 4, "model": 2}
    with pytest.raises(AssertionError):
        tmesh.make_mesh(data=3, model=3, world=8)
    with pytest.raises(AssertionError):
        tmesh.make_mesh(model=3, world=8)


@pytest.mark.parametrize("batch,world,on_idle", [
    (8, 8, "error"), (4, 8, "error"), (2, 8, "error"), (2, 8, "warn"), (1, 8, "error"),
    (3, 8, "warn"), (6, 4, "error"), (1, 2, "error"), (4, 4, "error")])
def test_default_world_model_axis_matches_default_mesh(batch, world, on_idle):
    """model=2: the data axis is use_tpu's over `world` devices; where use_tpu
    refuses, the port raises the same message."""
    devices = jax.devices()[:world]
    try:
        want = jmesh.default_mesh(batch, model=2, devices=devices, on_idle=on_idle).shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.default_world(batch, world=world, on_idle=on_idle, model=2)
        assert str(got.value) == str(e)
        return
    w = tmesh.default_world(batch, world=world, on_idle=on_idle, model=2)
    assert w.shape == dict(want) and w.trains


# -- four gloo ranks -------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_ranks(tmp, spec):
    """The four worker processes on `spec` (saved to `tmp`), started."""
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)
    port = _free_port()
    procs = []
    for rank in range(4):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "PYTHONPATH": REPO,
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.helpers.torch_tp_worker", spec_path,
             str(tmp / f"rank{rank}.pt")], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """use_tpu's test net, params, batch and key; the four port ranks on
    them (started first, so that they run while use_tpu compiles); use_tpu's
    DP and sharded steps with and without the binding clip, and its
    gradient over the batch. -> (spec, the ranks' outputs, use_tpu's side)."""
    jm = JScoreModel(**NET, backbone_kwargs=NET_KWARGS)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"clean": rng.standard_normal((4, 1000)).astype(np.float32),
             "perturbed": rng.standard_normal((4, 1000)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    tmp = tmp_path_factory.mktemp("tp")
    spec = {"model": dict(NET, backbone_kwargs=dict(NET_KWARGS, remat=True,
                                                     remat_policy="conv_outs")),
            "params": jax.tree.map(np.asarray, jax.device_get(params)), "min_size": MIN_SIZE,
            "lr": LR, "batch": batch, "draws": jax_draws(jm, key, batch),
            "cases": [{"name": "step", "grad_clip": None},
                      {"name": "clip", "grad_clip": CLIP},
                      {"name": "summing", "grad_clip": None, "summing": True}]}
    procs = _launch_ranks(tmp, spec)
    try:
        devices = jax.devices()[:4]
        mesh_dp = jmesh.make_mesh(data=4, model=1, devices=devices)
        mesh_tp = jmesh.make_mesh(data=2, model=2, devices=devices)
        steps = {}
        for case, clip in (("step", None), ("clip", CLIP)):
            tx = joptim.adam(lr=LR, weight_decay=0.0, grad_clip=clip, params_example=params)
            step = make_sgmse_train_step(jm, tx, accum=1, donate=False)
            st_dp = JTrainState.create(
                jax.tree.map(lambda p: jax.device_put(p, jmesh.replicated(mesh_dp)), params), tx)
            st_tp = JTrainState.create(jsharding.shard_params(params, mesh_tp, MIN_SIZE), tx)
            steps[case] = {name: step(st, jmesh.shard_batch(batch, m), key)
                           for name, st, m in (("dp", st_dp, mesh_dp), ("tp", st_tp, mesh_tp))}
        grads = jax.grad(jm.train_loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                        key)
        grads = ncsnpp_params_to_state_dict(jax.device_get(grads))
        grads.pop("all_modules.0.W")  # frozen: use_tpu's stop_gradient
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(4)]
    return spec, outs, (params, steps, grads)


def _params_off(got, new_params):
    """The largest |port - use_tpu| over the parameters after the step."""
    want = ncsnpp_params_to_state_dict(jax.device_get(new_params))
    return max(float((got[k] - torch.as_tensor(np.asarray(w))).abs().max())
               for k, w in want.items())


def test_ranks_lay_out_row_major(tp_run):
    _, outs, _ = tp_run
    assert [(o["rank"], o["data_rank"], o["model_rank"]) for o in outs] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert all(o["shape"] == {"data": 2, "model": 2} for o in outs)
    assert len(outs[0]["step"]["sharded"]) == 19


@pytest.mark.parametrize("case", ["step", "clip"])
def test_sharded_step_matches_jax_sharded_and_data_parallel_steps(tp_run, case):
    """The loss within rtol 1e-5, the gathered parameters after the step
    within 1e-4 of use_tpu's sharded step's and of its DP step's; the
    gradient the optimizer applied, gathered whole, use_tpu's over the
    batch (clipped by optax's rule in the clip case, whose clip binds)."""
    _, outs, (_, steps, grads_j) = tp_run
    for name in ("dp", "tp"):
        _, m = steps[case][name]
        np.testing.assert_allclose(outs[0][case]["loss"], float(m["loss_Score"]), rtol=1e-5)
    norm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in grads_j.values())))
    scale = 1.0
    if case == "clip":
        assert norm > CLIP  # the clip binds
        scale = CLIP / norm
    for out in outs:
        assert out[case]["loss"] == outs[0][case]["loss"]
        _grads_close(out[case]["grads"], {k: np.asarray(g) * scale for k, g in grads_j.items()})
        for name in ("dp", "tp"):
            new, _ = steps[case][name]
            off = _params_off(out[case]["params"], new.params)
            assert off < 1e-4, (case, name, off)


def test_replicas_and_slices_bit_identical(tp_run):
    """After the step, each replicated parameter is the same on all four
    ranks and each slice the same across its data group."""
    _, outs, _ = tp_run
    for case in ("step", "clip"):
        sharded = set(outs[0][case]["sharded"])
        for k, v in outs[0][case]["local"].items():
            peers = outs[2:3] if k in sharded else outs[1:]
            for o in peers:
                assert torch.equal(o[case]["local"][k], v), (case, k)
        for k in sharded:
            assert torch.equal(outs[1][case]["local"][k], outs[3][case]["local"][k])
            assert not torch.equal(outs[0][case]["local"][k], outs[1][case]["local"][k])


def test_summing_gather_backward_fails_the_gates(tp_run):
    """The control: a gather whose backward sums over the model ranks
    (torch.distributed.nn's all_gather) multiplies the gradients upstream
    of each gather by the model axis; its step leaves the gates."""
    _, outs, (_, steps, grads_j) = tp_run
    out = outs[0]["summing"]
    np.testing.assert_allclose(out["loss"], outs[0]["step"]["loss"], rtol=0)  # the forward
    with pytest.raises(AssertionError):
        _grads_close(out["grads"], grads_j)
    new, _ = steps["step"]["tp"]
    assert _params_off(out["params"], new.params) > 1e-4


def test_shard_then_gather_round_trips_and_serves(tp_run):
    """The gathered state of the sharded net, before the step, is use_tpu's
    params converted, bit for bit, on every rank, and an unsharded net that
    loads it computes the forward of one that loads the conversion."""
    spec, outs, (params, _, _) = tp_run
    want = ncsnpp_params_to_state_dict(jax.device_get(params))
    for out in outs:
        got = out["step"]["gathered_before"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    nets = []
    for sd in (outs[3]["step"]["gathered_before"], want):
        m = TScoreModel(**spec["model"], device="cpu")
        m.score_net.load_state_dict(sd)
        nets.append(m.score_net)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, 16, 4))
                         .astype(np.float32))
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        assert torch.equal(nets[0](x, t), nets[1](x, t))


class _TransposedOwner(torch.nn.Module):
    """A transposed conv in a net whose plain convs may be cut."""

    shards_plain_convs = True

    def __init__(self):
        super().__init__()
        self.up = torch.nn.ConvTranspose1d(64, 64, 16, stride=8)


class _JTransposed(jnn.Module):
    """use_tpu's side of _TransposedOwner: Flax's ConvTranspose, [k, I, O]."""

    @jnn.compact
    def __call__(self, x):
        return jnn.ConvTranspose(64, (16,), strides=(8,), name="up")(x)


def _now_cut(build):
    """(the port's net, use_tpu's params shapes, their converter, min_size)
    of a build the port refused before it cut transposed convs, the zoo's
    nets and the int8 convs."""
    from use_tpu.models.convtasnet import ConvTasNet as JConvTasNet
    from use_tpu.models.gan.hifigan_vocoder import HifiganGenerator as JHifigan
    from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
    from use_tpu_torch.engine import convert_jax
    from use_tpu_torch.models.convtasnet import ConvTasNet
    from use_tpu_torch.models.gan.hifigan_vocoder import HifiganGenerator

    def init(module, *shape):
        return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                              jnp.zeros(shape, jnp.float32))["params"]

    if build == "hifigan_generator":
        with torch.device("meta"):
            net = HifiganGenerator()
        return (net, init(JHifigan(), 1, 8, 80), convert_jax.hifigan_generator_params_to_state_dict,
                1 << 16)
    if build == "convtasnet":
        with torch.device("meta"):
            net = ConvTasNet()
        return net, init(JConvTasNet(), 1, 1600), convert_jax.convtasnet_params_to_state_dict, 1 << 16
    if build == "conv_transpose":
        return (_TransposedOwner(), init(_JTransposed(), 1, 5, 64),
                lambda p: convert_jax.flax_params_to_state_dict(p, transposed=("up",)), 1 << 10)
    cfg = dict(nf=16, ch_mult=(1, 2), quant=build, quant_min_channels=16)
    params = jax.eval_shape(JNCSNpp(JConfig(**cfg)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 64, 4), jnp.float32), jnp.full((1,), 0.5))
    return (BackboneRegistry.get_by_name("ncsnpp")(**cfg), params["params"],
            ncsnpp_params_to_state_dict, 1 << 10)


def _assert_cut_as_use_tpu(build):
    """The plan of a build the port refused until it cut transposed convs
    (on dim 1, their output axis), the zoo's plain convs and the int8
    convs: exactly use_tpu's leaves, each on its output axis."""
    net, params, convert, min_size = _now_cut(build)
    mesh = jmesh.make_mesh(model=2, devices=jax.devices()[:8])
    specs = jax.tree_util.tree_leaves(jsharding.params_shardings(params, mesh, min_size))
    want = set()
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(params)[0], specs):
        tree = node = {}
        for key in path[:-1]:
            node = node.setdefault(key.key, {})
        node[path[-1].key] = np.zeros(leaf.shape, np.float32)
        if spec.spec != P():
            (name,) = convert(tree)
            want.add(name)
    plan = tsharding.params_shardings(net, tmesh.make_mesh(model=2, world=8), min_size)
    assert {k for k, axis in plan.items() if axis is not None} == want and want
    for k in want:
        owner = net.get_submodule(k.rpartition(".")[0])
        assert plan[k] == (1 if isinstance(owner, torch.nn.modules.conv._ConvTransposeNd) else 0)


class _Refused(torch.nn.Module):
    """Convs the port cannot cut where the rule shards their kernels."""

    shards_plain_convs = True

    def __init__(self, build):
        super().__init__()
        if build == "reflect_padding":
            self.conv = torch.nn.Conv1d(64, 64, 16, padding=1, padding_mode="reflect")
        else:
            self.conv = torch.nn.ConvTranspose1d(64, 64, 16, stride=8, groups=2)


@pytest.mark.parametrize("build", ["hifigan_generator", "conv_transpose", "convtasnet", "int8",
                                   "int8_pallas", "reflect_padding", "grouped_transposed",
                                   "outside_owner"])
def test_shard_params_refuses_what_the_port_cannot_shard(build):
    """shard_params refuses exactly what the port cannot cut. The nets it
    refused until it cut transposed convs, the zoo's plain convs and the
    int8 convs (HiFi-GAN's generator, a transposed conv, ConvTasNet, the
    int8 nets) are now cut as use_tpu cuts them. Where the rule shards a
    kernel of a module the port still cannot cut, it raises, naming it,
    and never replicates quietly: a conv that pads other than with zeros,
    a grouped transposed conv, a plain conv of a net that does not set
    shards_plain_convs."""
    if build in ("hifigan_generator", "conv_transpose", "convtasnet", "int8", "int8_pallas"):
        _assert_cut_as_use_tpu(build)
        return
    net = (torch.nn.Sequential(torch.nn.Conv1d(64, 64, 16)) if build == "outside_owner"
           else _Refused(build))
    with pytest.raises(ValueError, match=r"shard_params: \S+weight \((Conv1d|ConvTranspose1d), "):
        tsharding.shard_params(net, tmesh.make_mesh(model=2, world=4), 1 << 10)
