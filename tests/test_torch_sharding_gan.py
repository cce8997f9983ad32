"""The 'model' axis of use_tpu_torch on the GAN nets (parallel/sharding.py's
column-parallel plain convs) against use_tpu's parallel/sharding.py, on the
CPU.

- The rule: params_shardings names, through convert_jax's naming, exactly
  the leaves use_tpu's rule shards on every discriminator bank and on
  CSMGAN (the port on the meta device, use_tpu through jax.eval_shape;
  the rule's default min_size, and a small one where it cuts little).
- The step: four gloo ranks at (data=2, model=2)
  (tests/helpers/torch_tp_worker.py) take one gan_train_step of LSGAN on
  the generator and the period + mel bank of tests/test_torch_gan_train.py
  (GEN, PERIOD, MEL), both cut at MIN_SIZE, on use_tpu's params, batch and
  crop draw; against use_tpu's make_gan_train_step over shard_params'd G
  and D on the 8-device CPU mesh at (data=2, model=2) and over the data
  axis alone: the losses, the applied gradients gathered whole (against
  use_tpu's over the batch, G's against use_tpu's stepped D), the
  gathered parameters after both Adam steps. The same with a grad clip on
  both optimizers that binds, and CSMGAN's step (tiny, whole clips, the
  period bank), against use_tpu's step assembled from its gradients and
  its optimizers (each make_gan_train_step compiles for 20-30 s here).
- use_tpu's 24 kHz WaveDiscriminator cut (its grouped convs: groups 4, 16,
  64, 256 over the model axis) at its min_len samples: the logits, the
  feature maps and the input's gradient against use_tpu's sharded apply;
  grouped convs whose group count the model axis does not divide against
  the uncut conv.
- Replicas bit-identical on all four ranks and slices across each data
  group; shard then gather returns use_tpu's params converted, bit for bit.

Tolerances: the losses, gradients and parameters after the step as
tests/test_torch_gan_train.py argues them for the one-process step
(``_loss_close``, ``_grads_close``, ``_adam_step_close``: a first Adam step
is lr sign(g), so an element whose gradient is within rounding of 0 may
step either way: use_tpu's own sharded and data-parallel steps differ by
2 lr there). Module outputs within 1e-5 of their largest
|value| plus rtol 1e-4 (tests/test_torch_csmgan.py's); the grouped convs,
the same arithmetic in other shapes, within 1e-6 of their largest.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import use_tpu.models.gan  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, random_params
from tests.test_torch_csmgan import TINY as CSMGAN_TINY, JPeriodD
from tests.test_torch_gan_train import (
    CLIP as WAV_LEN,
    GEN,
    STEP_LOSS,
    JTinyD,
    _adam_step_close,
    _batch,
    _grads_close,
    _loss_close,
)
from tests.test_torch_sharding import _launch_ranks
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import GANTrainState as JGANState, TrainState as JTrainState
from use_tpu.engine.train import make_gan_train_step
from use_tpu.models.gan import csmgan as jc
from use_tpu.models.gan import discriminators as jdisc, losses as jlosses
from use_tpu.models.gan import msd as jmsd, spec_discriminator as jspec
from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
from use_tpu.models.gan.lsgan import LSGAN as JLSGAN
from use_tpu.parallel import mesh as jmesh
from use_tpu.parallel import sharding as jsharding
from use_tpu_torch.engine.convert_jax import (
    csmgan_params_to_state_dict,
    discriminator_params_to_state_dict,
    lsgan_params_to_state_dict,
)
from use_tpu_torch.models.gan import csmgan as tc
from use_tpu_torch.models.gan import discriminators as tdisc
from use_tpu_torch.models.gan import msd as tmsd, spec_discriminator as tspec
from use_tpu_torch.parallel import mesh as tmesh
from use_tpu_torch.parallel import sharding as tsharding

MIN_SIZE = 32  # every conv whose output axis divides by 2 is cut
G_LR, D_LR, WD = 5e-4, 2e-4, 1e-7
# the binding clip of both optimizers: far under either gradient's norm,
# so that the clipped gradients sit near Adam's eps, where the step depends
# on their scale
CLIP = 1e-5
GROUPED = [((6, 6, 3), 3), ((6, 12, 3), 3), ((10, 10, 3), 5)]  # (in, out, k), groups
WAVE_MIN_SIZE = 1 << 10  # cuts conv1 .. conv6 (groups 4, 16, 64, 256, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the rule ---------------------------------------------------------------

def _jax_sharded(params, convert, min_size, model=2):
    """{port name: size} of the leaves use_tpu's rule shards."""
    mesh = jmesh.make_mesh(model=model, devices=jax.devices()[:8])
    specs = jax.tree_util.tree_leaves(jsharding.params_shardings(params, mesh, min_size))
    out = {}
    for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(params)[0], specs):
        if s.spec == P():
            continue
        tree = node = {}
        for key in path[:-1]:
            node = node.setdefault(key.key, {})
        node[path[-1].key] = np.zeros(leaf.shape, np.float32)
        (name,) = convert(tree)
        out[name] = int(np.prod(leaf.shape))
    return out


BANKS = {
    "24k_MVD": (jdisc.HifiganVocoderDiscriminator24kMVD, tdisc.HifiganVocoderDiscriminator24kMVD),
    "24k": (jdisc.HifiganVocoderDiscriminator24k, tdisc.HifiganVocoderDiscriminator24k),
    "MPD": (jdisc.MultiPeriodDiscriminator, tdisc.MultiPeriodDiscriminator),
    "MVD": (jdisc.MultiWaveDiscriminator, tdisc.MultiWaveDiscriminator),
    "MMD": (jdisc.MultiMelSpecDiscriminator, tdisc.MultiMelSpecDiscriminator),
    "MSD": (jmsd.MultiScaleDiscriminator, tmsd.MultiScaleDiscriminator),
    "spec": (jspec.SpecDiscriminator, tspec.SpecDiscriminator),
    "multi_spec": (jspec.MultiSpecDiscriminator, tspec.MultiSpecDiscriminator),
}


@pytest.mark.parametrize("name,min_size,count,size,convs", [
    ("24k_MVD", 1 << 16, 31, 75_857_920, {"Conv2d": 15, "Conv1d": 16}),
    ("24k", 1 << 16, 33, 70_543_360, {"Conv2d": 15, "Conv1d": 18}),
    ("MPD", 1 << 16, 15, 40_960_000, {"Conv2d": 15}),
    ("MVD", 1 << 16, 16, 34_897_920, {"Conv1d": 16}),
    ("MMD", 1 << 16, 0, 0, {}),
    ("MMD", 1 << 10, 12, 304_320, {"Conv2d": 12}),
    ("MSD", 1 << 16, 18, 29_583_360, {"Conv1d": 18}),
    ("spec", 1 << 16, 1, 246_240, {"Conv2d": 1}),
    ("multi_spec", 1 << 16, 0, 0, {}),
    ("spec", 1 << 8, 5, 285_152, {"Conv2d": 5}),
    ("csmgan", 1 << 16, 41, 14_515_200, {"Conv2d": 3, "Conv1d": 38}),
])
def test_rule_matches_jax_on_the_gan_nets(name, min_size, count, size, convs):
    """Exactly use_tpu's leaves, on the output axis (which divides by 2
    wherever the rule cuts), each a plain torch conv of the net."""
    if name == "csmgan":
        jw = jc.CSMGANWrapper()
        want = _jax_sharded(jax.eval_shape(jw.init_params, jax.random.PRNGKey(0)),
                            csmgan_params_to_state_dict, min_size)
        with torch.device("meta"):
            net = tc.CSMGAN()
    else:
        jcls, tcls = BANKS[name]
        params = jax.eval_shape(lambda: jcls().init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 24000))))["params"]
        want = _jax_sharded(params, discriminator_params_to_state_dict, min_size)
        with torch.device("meta"):
            net = tcls()
    plan = tsharding.params_shardings(net, tmesh.make_mesh(model=2, world=8), min_size)
    sizes = {k: p.numel() for k, p in net.named_parameters()}
    got = {k: sizes[k] for k, axis in plan.items() if axis is not None}
    assert got == want
    assert (len(got), sum(got.values())) == (count, size)
    kinds = [type(net.get_submodule(k.rpartition(".")[0])).__name__ for k in got]
    assert {k: kinds.count(k) for k in set(kinds)} == convs


# -- four gloo ranks --------------------------------------------------------

def _lsgan_setup():
    jgan = JLSGAN(generator=JGenerator(**GEN), discriminator=JTinyD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_shape, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), WAV_LEN))
    g_params, d_params = random_params(g_shape, seed=1), random_params(d_shape, seed=2)
    batch = _batch(10, n=2)
    rng = jax.random.PRNGKey(3)
    (r,) = jax.random.split(rng, 1)
    start = int(jax.random.randint(r, (), 0, WAV_LEN - 496))
    return jgan, g_params, d_params, batch, rng, r, start


def _csmgan_setup():
    jw = jc.CSMGANWrapper(**CSMGAN_TINY)
    jgan = JLSGAN(generator=jw, discriminator=JPeriodD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_params = random_params(jax.eval_shape(jw.init_params, jax.random.PRNGKey(0)), seed=3)
    _, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), 2400))
    rng = np.random.default_rng(10)
    clean = (0.3 * rng.standard_normal((2, 2400))).astype(np.float32)
    batch = {"clean": clean, "perturbed": (clean + 0.1 * rng.standard_normal(clean.shape))
             .astype(np.float32)}
    return jgan, g_params, random_params(d_shape, seed=2), batch


def _wave_setup():
    jd = jdisc.WaveDiscriminator(sample_rate=24000)
    x = (0.3 * np.random.default_rng(4).standard_normal((2, tdisc.WaveDiscriminator().min_len))
         ).astype(np.float32)
    params = random_params(jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x)))["params"], seed=5)
    return jd, params, x


def _grouped_setup(conv, groups, seed):
    rng = np.random.default_rng(seed)
    cin, cout, k = conv
    params = {"conv": {"kernel": (rng.standard_normal((k, cin // groups, cout)) / 3)
                       .astype(np.float32),
                       "bias": rng.standard_normal(cout).astype(np.float32)}}
    return params, rng.standard_normal((2, cin, 17)).astype(np.float32)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four port ranks on every case (started first, so that they run
    while use_tpu compiles), then use_tpu's side. -> (the ranks' outputs,
    use_tpu's results)."""
    jgan, g_params, d_params, batch, rng, r, start = _lsgan_setup()
    cgan, cg_params, cd_params, cbatch = _csmgan_setup()
    jd, w_params, wx = _wave_setup()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    gan = dict(kind="gan", generator=GEN, g_params=np_tree(g_params),
               d_params=np_tree(d_params), batch=batch, starts=[start])
    cases = [dict(gan, name="gan"), dict(gan, name="gan_clip", grad_clip=CLIP),
             dict(name="csmgan", kind="csmgan", generator=dict(CSMGAN_TINY, seed=0),
                  g_params=np_tree(cg_params), d_params=np_tree(cd_params), batch=cbatch),
             dict(name="wave", kind="wave", params=np_tree(w_params), x=wx,
                  min_size=WAVE_MIN_SIZE)]
    grouped = [_grouped_setup(conv, g, i) for i, (conv, g) in enumerate(GROUPED)]
    cases += [dict(name=f"grouped{i}", kind="grouped", conv=conv, groups=g, params=p, x=x,
                   min_size=1) for i, ((conv, g), (p, x)) in enumerate(zip(GROUPED, grouped))]
    spec = {"min_size": MIN_SIZE, "g_lr": G_LR, "d_lr": D_LR, "weight_decay": WD,
            "g_loss": STEP_LOSS, "cases": cases}
    procs = _launch_ranks(tmp_path_factory.mktemp("tp_gan"), spec)
    try:
        jax_side = _jax_side(jgan, g_params, d_params, batch, rng, r, cgan, cg_params,
                             cd_params, cbatch, jd, w_params, wx)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    tmp = os.path.dirname(procs[0].args[-1])
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    return outs, jax_side, grouped


def _jax_side(jgan, g_params, d_params, batch, rng, r, cgan, cg_params, cd_params, cbatch,
              jd, w_params, wx):
    """use_tpu's LSGAN steps (make_gan_train_step, sharded at (2, 2) and
    data-parallel), its gradients over the batch (G's against the sharded
    step's D); the clip case and CSMGAN's step from use_tpu's own pieces
    (its gradients, its clipping Adam's update, G's gradient against the
    stepped D, as make_gan_train_step runs them: one compile each fewer);
    the WaveDiscriminator's sharded apply."""
    devices = jax.devices()[:4]
    mesh_tp = jmesh.make_mesh(data=2, model=2, devices=devices)
    mesh_dp = jmesh.make_mesh(data=2, model=1, devices=devices[:2])
    g_tx, d_tx = (joptim.adam(lr, WD, params_example=p)
                  for lr, p in ((G_LR, g_params), (D_LR, d_params)))
    step = make_gan_train_step(jgan, g_tx, d_tx, accum=1, donate=False)

    def mesh_step(mesh):
        st = JGANState(*(JTrainState.create(jsharding.shard_params(p, mesh, MIN_SIZE), tx)
                         for p, tx in ((g_params, g_tx), (d_params, d_tx))))
        return step(st, jmesh.shard_batch(batch, mesh), rng)

    def pieces(gan, r):
        @jax.jit
        def run(gp, dp, new_dp, mb):
            fake = jax.lax.stop_gradient(gan.g_forward(gp, mb, r))
            loss_d, gd = jax.value_and_grad(gan.d_loss)(dp, fake)
            (_, logs), gg = jax.value_and_grad(
                lambda p: gan.g_loss(new_dp, gan.g_forward(p, mb, r)), has_aux=True)(gp)
            return loss_d, logs, gd, gg

        return run

    def stepped(run, gp, dp, mb, clip=None):
        """use_tpu's step from its pieces: D's Adam step, then G's gradient
        against the stepped D and G's Adam step."""
        g_tx, d_tx = (joptim.adam(lr, WD, grad_clip=clip, params_example=p)
                      for lr, p in ((G_LR, gp), (D_LR, dp)))
        def adam(p, g, tx):
            return jax.jit(lambda st, g: st.apply_gradients(g, tx))(JTrainState.create(p, tx), g)

        _, _, gd, _ = run(gp, dp, dp, mb)
        new_d = adam(dp, gd, d_tx)
        loss_d, logs, _, gg = run(gp, dp, jax.device_get(new_d.params), mb)
        new_g = adam(gp, gg, g_tx)
        return jax.device_get(((JGANState(g=new_g, d=new_d), {"loss_D": loss_d, **logs}),
                               (gd, gg)))

    run = pieces(jgan, r)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the compiles overlap in threads
    with ThreadPoolExecutor(4) as pool:
        jobs = {("gan", "tp"): pool.submit(mesh_step, mesh_tp),
                ("gan", "dp"): pool.submit(mesh_step, mesh_dp),
                "gan_clip": pool.submit(stepped, run, g_params, d_params, jb, CLIP),
                "csmgan": pool.submit(stepped, pieces(cgan, None), cg_params, cd_params,
                                      {k: jnp.asarray(v) for k, v in cbatch.items()})}
        out = {k: job.result() for k, job in jobs.items()}
    out["gan_clip", "tp"], out["gan_clip", "grads"] = out.pop("gan_clip")
    new, _ = out["gan", "tp"]
    out["gan", "grads"] = jax.device_get(run(g_params, d_params, jax.device_get(new.d.params),
                                             jb)[2:])
    # the WaveDiscriminator, sharded at (2, 2)
    wp = jsharding.shard_params(w_params, mesh_tp, WAVE_MIN_SIZE)

    def total(p, x):
        lg, fm = jd.apply({"params": p}, x)
        return lg.sum() + sum(f.sum() for f in fm), (lg, fm)

    (_, outputs), x_grad = jax.jit(jax.value_and_grad(total, argnums=1, has_aux=True))(
        wp, jnp.asarray(wx))
    out["wave"] = jax.device_get((outputs, x_grad))
    return out


def test_ranks_cut_every_case(tp_run):
    """The rule cut the plain convs of both nets on every rank, the layout
    row-major, and a cut conv runs as a ColumnParallelConv."""
    outs, _, _ = tp_run
    assert [(o["rank"], o["data_rank"], o["model_rank"]) for o in outs] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    gan = outs[0]["gan"]
    d_cut = gan["sharded"]["d"]
    assert {k.split(".")[0] for k in d_cut} == {"period2", "period3", "mel0"}
    assert len(gan["sharded"]["g"]) > 0 and len(outs[0]["csmgan"]["sharded"]["g"]) > 0
    assert "ColumnParallelConv1d" in outs[0]["wave"]["classes"]
    for o in outs[1:]:
        assert o["gan"]["sharded"] == gan["sharded"]


def _applied(out, grads_j, scale=(1.0, 1.0)):
    gd, gg = grads_j
    want_d = {k: np.asarray(v) * scale[1] for k, v in
              discriminator_params_to_state_dict(gd).items()}
    want_g = {k: np.asarray(v) * scale[0] for k, v in lsgan_params_to_state_dict(gg).items()}
    _grads_close(out["grads"]["d"], want_d)
    _grads_close(out["grads"]["g"], want_g)
    return want_g, want_d


def _norm(tree):
    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum()) for g in
                             jax.tree_util.tree_leaves(tree))))


@pytest.mark.parametrize("case", ["gan", "gan_clip"])
def test_sharded_gan_step_matches_jax_sharded_and_data_parallel_steps(tp_run, case):
    """The losses, the gradients D and G applied (gathered; clipped by
    optax's rule in the clip case, whose clip binds on both) and the
    gathered parameters after both Adam steps, on every rank, against
    use_tpu's sharded and data-parallel make_gan_train_step (the clip case:
    against use_tpu's clipping Adam on its gradients)."""
    outs, jside, _ = tp_run
    grads_j = jside[case, "grads"]
    scale = (1.0, 1.0)
    if case == "gan_clip":
        norms = (_norm(grads_j[1]), _norm(grads_j[0]))
        assert min(norms) > 10 * CLIP  # the clip binds on both
        scale = (CLIP / norms[0], CLIP / norms[1])
    names = ("tp", "dp") if case == "gan" else ("tp",)
    for out in outs:
        got = out[case]
        for name in names:
            _, metrics = jside[case, name]
            assert set(got["metrics"]) == set(metrics)
            for k, v in got["metrics"].items():
                _loss_close(k, v, metrics[k])
        want_g, want_d = _applied(got, grads_j, scale)
        for name in names:
            new, _ = jside[case, name]
            nets = {"g": (lsgan_params_to_state_dict(jax.device_get(new.g.params)), want_g, G_LR),
                    "d": (discriminator_params_to_state_dict(jax.device_get(new.d.params)),
                          want_d, D_LR)}
            for net, (params, grads, lr) in nets.items():
                _adam_step_close(_Params(got["params"][net]), params, grads, lr)


class _Params:
    """A state dict as _adam_step_close reads a module's parameters."""

    def __init__(self, state):
        self.state = state

    def named_parameters(self):
        return ((k, torch.nn.Parameter(v, requires_grad=True)) for k, v in self.state.items())


def test_sharded_csmgan_step_matches_jax(tp_run):
    """CSMGAN's step gathered: the losses, D's and G's applied gradients
    (the last TCN block's res_out reaches no output: no gradient on any
    rank, 0 in use_tpu's) and the parameters after both Adam steps."""
    outs, jside, _ = tp_run
    (new, metrics), (gd_j, gg_j) = jside["csmgan"]
    want_d = discriminator_params_to_state_dict(gd_j)
    want_g = csmgan_params_to_state_dict(gg_j)
    for out in outs:
        got = out["csmgan"]
        assert set(got["metrics"]) == set(metrics)
        for k, v in got["metrics"].items():
            _loss_close(k, v, metrics[k])
        _grads_close(got["grads"]["d"], want_d)
        unused = sorted(set(want_g) - set(got["grads"]["g"]))
        assert unused == ["bottleneck.TCN.1.res_out.bias", "bottleneck.TCN.1.res_out.weight"]
        grads_g = dict(got["grads"]["g"])
        for k in unused:
            assert not want_g[k].any()
            grads_g[k] = torch.zeros_like(want_g[k])
        _grads_close(grads_g, want_g)
        _adam_step_close(_Params(got["params"]["d"]),
                         discriminator_params_to_state_dict(new.d.params), want_d, D_LR)
        _adam_step_close(_Params(got["params"]["g"]), csmgan_params_to_state_dict(new.g.params),
                         want_g, G_LR)


def test_wave_discriminator_cut_matches_jax_sharded_apply(tp_run):
    """use_tpu's WaveDiscriminator at 24 kHz on min_len samples: the logits,
    the seven feature maps (NWC there) and the input's gradient of their
    sum, the grouped convs cut over the model axis."""
    outs, jside, _ = tp_run
    (lg, fm), x_grad = jside["wave"]
    want = [np.asarray(lg)] + [np.transpose(np.asarray(f), (0, 2, 1)) for f in fm]
    assert len(outs[0]["wave"]["sharded"]) == 6
    for out in outs:
        got = out["wave"]
        for g, w in zip(got["outputs"], want):
            assert_close(g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))
        assert_close(got["x_grad"], np.asarray(x_grad), rtol=1e-4,
                     atol=1e-5 * float(np.abs(np.asarray(x_grad)).max()))


@pytest.mark.parametrize("i", range(len(GROUPED)))
def test_grouped_conv_cut_where_the_axis_does_not_divide_the_groups(tp_run, i):
    """groups 3 and 5 over a model axis of 2 (a rank's slice starts or ends
    inside a group): the output, the input's gradient and the weight's
    gradient gathered whole equal the uncut conv's."""
    outs, _, grouped = tp_run
    (cin, cout, k), groups = GROUPED[i]
    params, x = grouped[i]
    sd = discriminator_params_to_state_dict(params)
    conv = torch.nn.Conv1d(cin, cout, k, groups=groups)
    conv.load_state_dict({k.partition(".")[2]: v for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = conv(xt)
    y.sum().backward()
    for out in outs:
        got = out[f"grouped{i}"]
        assert got["sharded"] == ["conv.weight"]
        for g, w in ((got["outputs"][0], y.detach()), (got["x_grad"], xt.grad),
                     (got["grads"]["conv.weight"], conv.weight.grad),
                     (got["grads"]["conv.bias"], conv.bias.grad)):
            assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))


def test_replicas_and_slices_bit_identical(tp_run):
    """After the steps, each replicated parameter of G and D is the same on
    all four ranks and each slice the same across its data group (and not
    across its model group)."""
    outs, _, _ = tp_run
    for case in ("gan", "gan_clip", "csmgan"):
        for net in ("g", "d"):
            sharded = set(outs[0][case]["sharded"][net])
            for k, v in outs[0][case]["local"][net].items():
                peers = outs[2:3] if k in sharded else outs[1:]
                for o in peers:
                    assert torch.equal(o[case]["local"][net][k], v), (case, net, k)
            for k in sharded:
                assert torch.equal(outs[1][case]["local"][net][k],
                                   outs[3][case]["local"][net][k])
                assert not torch.equal(outs[0][case]["local"][net][k],
                                       outs[1][case]["local"][net][k])


def test_shard_then_gather_round_trips(tp_run):
    """The gathered state of each cut net, before the step, is use_tpu's
    params converted, bit for bit, on every rank."""
    _, g_params, d_params, *_ = _lsgan_setup()
    _, cg_params, cd_params, _ = _csmgan_setup()
    outs, _, _ = tp_run
    wants = {"gan": (lsgan_params_to_state_dict(g_params),
                     discriminator_params_to_state_dict(d_params)),
             "csmgan": (csmgan_params_to_state_dict(cg_params),
                        discriminator_params_to_state_dict(cd_params))}
    for case, (want_g, want_d) in wants.items():
        for out in outs:
            for net, want in (("g", want_g), ("d", want_d)):
                got = out[case]["gathered_before"][net]
                assert got.keys() == want.keys()
                for k, v in want.items():
                    assert torch.equal(got[k], v), (case, net, k)
