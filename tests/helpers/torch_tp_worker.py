"""One rank of the port's (data=2, model=2) tensor-parallel CPU checks.

Launched four times by tests/test_torch_sharding.py with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
imports torch, use_tpu_torch and chip_smoke's summing-backward control
(no JAX). ``python -m tests.helpers.
torch_tp_worker <spec.pt> <out.pt>``: joins the gloo group, lays the four
ranks out as make_mesh(data=2, model=2), and for each case of the spec
builds the score model, shards it (``shard_params``), loads this rank's
slices of use_tpu's params (``convert_jax.ncsnpp_params_to_shards``) and
takes one sgmse_train_step through DDP over the data group on its data
index's rows of the global batch and draws (the case ``summing``: with
the gather's backward summing over the model ranks). Saved for the parent: the
gathered state before the step (the round trip), the gradient the
optimizer applied (after the clip) and the parameters after the step,
both gathered whole, the reported loss, and this rank's own parameters
(the replicas' and slices' bit-equality across ranks).

tests/test_torch_sharding_gan.py's spec gives each case a ``kind``:

- ``gan``: LSGAN with the NCSN++ generator and the period + mel bank of
  tests/test_torch_gan_train.py, both nets cut, use_tpu's G and D params
  loaded (``ncsnpp_params_to_shards``, ``discriminator_params_to_shards``),
  one gan_train_step on the given crop start (optionally with a grad clip
  on both optimizers): the losses, each network's applied gradient and its
  parameters after the step gathered whole, the gathered state before the
  step, this rank's own parameters;
- ``csmgan``: the same with a tiny CSMGAN generator
  (``csmgan_params_to_shards``) and the period bank alone;
- ``wave``: use_tpu's 24 kHz WaveDiscriminator cut, its logits, feature
  maps and the input's gradient of their sum;
- ``grouped``: a grouped Conv1d whose group count the model axis does not
  divide, cut: its output and the input's and weight's gradients.

tests/test_torch_sharding_zoo.py's kind ``zoo``: a net of the zoo (``ZOO``:
the HiFi-GAN and BWE generators, GaGNet, ConvTasNet, the NCSNv1 blocks, a
transposed conv with and without the causal trim) cut and loaded from its
full state dict, its outputs and the inputs' gradients of their sum, the
gathered state before the pass.

tests/test_torch_sharding_serving.py's kinds:

- ``serving``: an int8 NCSN++ (``quant='int8'`` or ``'int8_pallas'``) cut
  and loaded with ``convert_jax.ncsnpp_params_to_shards`` from use_tpu's
  params (the uncut net from their state dict), its forward on this data rank's
  lanes; each quantized conv call recorded and its output gathered, held
  bit for bit against the same conv of the uncut net on the same
  arguments, as is the control (the bias added after the gather) -
  chip_smoke's phase 35 helpers, ``cut_int8_calls`` and
  ``check_cut_int8_calls``; the uncut net's forward; where the
  case has a score model, a 2-step ``pc`` sample of the cut net and of the
  uncut one;
- ``gate``: a QConv whose output slice falls under the dynamic path's
  gate and whose whole output does not, cut: its output against the uncut
  conv's.
"""
import contextlib
import sys

import torch


def _gathered(net, grads, world):
    """{name: the whole tensor} of a {name: this rank's tensor} of `net`'s
    parameters, the slices gathered over the model group."""
    from use_tpu_torch.parallel import sharding

    return sharding.gather_slices(net, grads, world)


def step_case(spec, case, world):
    from use_tpu_torch.engine import optim
    from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_shards
    from use_tpu_torch.engine.state import TrainState
    from use_tpu_torch.engine.train import sgmse_train_step
    from use_tpu_torch.models.sgmse.score_model import ScoreModel
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import local_rows, wrap

    model = ScoreModel(**spec["model"], device="cpu")
    net = model.score_net
    plan = sharding.shard_params(net, world, spec["min_size"])
    net.load_state_dict(ncsnpp_params_to_shards(spec["params"], plan, world))
    out = {"plan": plan, "gathered_before": {
        k: v.clone() for k, v in sharding.gather_state_dict(net, world).items()}}
    state = TrainState.create(net, optim.adam(optim.trainable(net), spec["lr"], 0.0),
                              grad_clip=case["grad_clip"])
    state.world, state.ddp = world, wrap(net, world, torch.device("cpu"))
    real = state.optimizer.step

    def step(*a, **kw):
        out["grads"] = _gathered(net, {k: p.grad.clone() for k, p in net.named_parameters()
                                       if p.grad is not None}, world)
        return real(*a, **kw)

    state.optimizer.step = step
    start, t, z = spec["draws"]
    rows = {k: local_rows(torch.from_numpy(v), world) for k, v in spec["batch"].items()}
    from chip_smoke import summing_gather_backward

    broken = summing_gather_backward() if case.get("summing") else contextlib.nullcontext()
    with broken:
        metrics = sgmse_train_step(model, state, [rows],
                                   draws=[(start, local_rows(t, world), local_rows(z, world))])
    out.update(loss=float(metrics["loss_Score"]), params=sharding.gather_state_dict(net, world),
               local={k: p.detach().clone() for k, p in net.named_parameters()},
               sharded=sorted(sharding.sharded_parameters(net)))
    return out


class PeriodBank(torch.nn.Module):
    """The period discriminators at 2 and 3 (the D of
    tests/test_torch_csmgan.py)."""

    def __init__(self):
        super().__init__()
        from use_tpu_torch.models.gan import discriminators as tdisc

        period = dict(channels=8, max_downsample_channels=32)
        self.period2 = tdisc.PeriodDiscriminator(period=2, **period)
        self.period3 = tdisc.PeriodDiscriminator(period=3, **period)

    def forward(self, x):
        per = [self.period2(x), self.period3(x)]
        return [[o[0] for o in per]], [[o[1] for o in per]]


def _t(batch):
    import numpy as np

    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def gan_case(spec, case, world):
    """One sharded gan_train_step of LSGAN (``gan``) or CSMGAN (``csmgan``)."""
    from use_tpu_torch.engine import convert_jax
    from use_tpu_torch.engine.loop import build_gan_train_state, distribute
    from use_tpu_torch.engine.train import gan_train_step
    from use_tpu_torch.models.gan.lsgan import LSGAN
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import local_rows

    spec = {**spec, **case}
    if case["kind"] == "gan":
        from tests.helpers.torch_ddp_worker import TinyD
        from use_tpu_torch.models.gan.generator import NCSNPPWrapper

        gen, d = NCSNPPWrapper(**spec["generator"], device="cpu"), TinyD()
        to_shards = convert_jax.ncsnpp_params_to_shards
    else:
        from use_tpu_torch.models.gan.csmgan import CSMGANWrapper

        gen, d = CSMGANWrapper(**spec["generator"], device="cpu"), PeriodBank()
        to_shards = convert_jax.csmgan_params_to_shards
    nets = {"g": gen.net, "d": d}
    plans = {k: sharding.shard_params(net, world, spec["min_size"]) for k, net in nets.items()}
    gen.net.load_state_dict(to_shards(spec["g_params"], plans["g"], world))
    d.load_state_dict(convert_jax.discriminator_params_to_shards(spec["d_params"], plans["d"],
                                                                 world))
    out = {"plans": plans, "sharded": {k: sorted(sharding.sharded_parameters(net))
                                       for k, net in nets.items()},
           "gathered_before": {k: {n: v.clone() for n, v in
                                   sharding.gather_state_dict(net, world).items()}
                               for k, net in nets.items()}}
    gan = LSGAN(generator=gen, discriminator=d, g_loss_cfg=dict(spec["g_loss"]))
    state = build_gan_train_state(gan, spec["g_lr"], spec["d_lr"], spec["weight_decay"])
    distribute(state.g, world, torch.device("cpu"),
               getattr(gen, "ddp_find_unused_parameters", False))
    distribute(state.d, world, torch.device("cpu"))
    grads = {}
    for name in ("g", "d"):
        st = getattr(state, name)
        st.grad_clip = case.get("grad_clip")
        real = st.optimizer.step

        def step(*a, name=name, st=st, real=real, **kw):
            grads[name] = _gathered(st.model, {k: p.grad.clone() for k, p in
                                               st.model.named_parameters()
                                               if p.grad is not None}, world)
            return real(*a, **kw)

        st.optimizer.step = step
    rows = {k: local_rows(v, world) for k, v in _t(spec["batch"]).items()}
    metrics = gan_train_step(gan, state, [rows], starts=spec.get("starts"))
    out.update(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
               params={k: sharding.gather_state_dict(net, world) for k, net in nets.items()},
               local={k: {n: p.detach().clone() for n, p in net.named_parameters()}
                      for k, net in nets.items()})
    return out


class _Owner(torch.nn.Module):
    """One conv in a net whose plain convs may be cut."""

    shards_plain_convs = True

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


def wave_case(spec, case, world):
    """use_tpu's WaveDiscriminator (or a grouped conv) cut, forward and the
    input's gradient of the sum of every output."""
    from use_tpu_torch.engine.convert_jax import discriminator_params_to_shards
    from use_tpu_torch.models.gan import discriminators as tdisc
    from use_tpu_torch.parallel import sharding

    if case["kind"] == "wave":
        net = tdisc.WaveDiscriminator(sample_rate=24000)
    else:
        net = _Owner(torch.nn.Conv1d(*case["conv"], groups=case["groups"]))
    plan = sharding.shard_params(net, world, case["min_size"])
    net.load_state_dict(discriminator_params_to_shards(case["params"], plan, world))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = net(x)
    flat = [y] if torch.is_tensor(y) else [y[0]] + list(y[1])
    sum(v.sum() for v in flat).backward()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    return {"outputs": [v.detach() for v in flat], "x_grad": x.grad.clone(),
            "grads": _gathered(net, grads, world), "sharded": sorted(
                sharding.sharded_parameters(net)),
            "classes": sorted({type(m).__name__ for m in net.modules()})}


def _zoo_net(name, kw):
    """The port's module of a ZOO case, and how it is called on (inputs,
    extra arguments)."""
    from use_tpu_torch.models import convtasnet, gagnet
    from use_tpu_torch.models.gan import hifigan_bwe, hifigan_vocoder
    from use_tpu_torch.models.ncsnpp import legacy_layers

    if name == "gagnet":
        net = gagnet.GaGNet(**kw["net"])
        net.materialize(kw["freqs"])
        return net, lambda xs, extra: net(*xs)
    if name == "refine":
        net = legacy_layers.RefineBlock(**kw)
        return net, lambda xs, extra: net(xs, *extra)
    if name in ("conv_transpose1d", "conv_transpose2d", "conv_transpose_c"):
        conv = (hifigan_vocoder.ConvTranspose1dC(**kw) if name == "conv_transpose_c" else
                getattr(torch.nn, name.replace("conv_transpose", "ConvTranspose"))(**kw))
        net = _Owner(conv)
        return net, lambda xs, extra: net(*xs)
    net = {"hifigan": hifigan_vocoder.HifiganGenerator, "bwe": hifigan_bwe.BandwidthExtender,
           "convtasnet": convtasnet.ConvTasNet, "residual": legacy_layers.ResidualBlock,
           "upsample_conv": legacy_layers.UpsampleConv}[name](**kw)
    return net, lambda xs, extra: net(*xs, *extra)


def zoo_case(spec, case, world):
    """A zoo net cut and loaded from its full state dict: its outputs and
    the inputs' gradients of the sum of every output."""
    from use_tpu_torch.parallel import sharding

    net, call = _zoo_net(case["net"], case["kwargs"])
    plan = sharding.shard_params(net, world, case["min_size"])
    net.load_state_dict(sharding.shard_state_dict(case["state"], plan, world))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in case["inputs"]]
    y = call(xs, case.get("extra", ()))
    flat = list(y) if isinstance(y, (tuple, list)) else [y]
    sum(v.sum() for v in flat).backward()
    return {"outputs": [v.detach() for v in flat], "x_grads": [x.grad.clone() for x in xs],
            "plan": plan, "sharded": sorted(sharding.sharded_parameters(net)),
            "gathered_before": sharding.gather_state_dict(net, world),
            "classes": sorted({type(m).__name__ for m in net.modules()})}


def _sample(model, batch, seed):
    return model.sample(batch, generator=torch.Generator().manual_seed(seed), N=2)["enhanced"]


def serving_case(spec, case, world):
    """An int8 NCSN++ cut over the model axis, against the uncut net on the
    same rank: the forward, every quantized conv call bit for bit, and a
    2-step pc sample of an int8 score model."""
    from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_shards
    from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp, NCSNppConfig
    from use_tpu_torch.models.sgmse.score_model import ScoreModel
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import local_rows

    cfg = NCSNppConfig(**case["config"])
    full, net = NCSNpp(cfg), NCSNpp(cfg)
    full.load_state_dict(case["state"])
    plan = sharding.shard_params(net, world, case["min_size"])
    shards = ncsnpp_params_to_shards(case["params"], plan, world)
    net.load_state_dict(shards)
    from chip_smoke import check_cut_int8_calls, cut_int8_calls

    names = {id(m): n for n, m in net.named_modules()}
    x, t = (local_rows(torch.from_numpy(v), world) for v in (case["x"], case["t"]))
    calls = []
    with torch.no_grad():
        with cut_int8_calls(calls):
            y = net(x, t)
        y_full = full(x, t)
        checked = check_cut_int8_calls(torch, calls, full, names, world)
    out = {"y": y, "y_full": y_full, "calls": checked, "plan": plan,
           "sharded": sorted(sharding.sharded_parameters(net)),
           "gathered_before": sharding.gather_state_dict(net, world)}
    if "score_model" not in case:
        return out
    models = [ScoreModel(**case["score_model"], device="cpu") for _ in range(2)]
    for m in models:
        m.score_net.load_state_dict(case["state"])
    sharding.shard_params(models[1].score_net, world, case["min_size"])
    models[1].score_net.load_state_dict(shards)
    batch = {"perturbed": torch.from_numpy(case["wav"])}
    out["sample"], out["sample_full"] = (_sample(m, batch, case["seed"]) for m in models[::-1])
    return out


def gate_case(spec, case, world):
    """A QConv (dynamic path) cut where its slice falls under the gate and
    its whole width does not: the output gathered, the uncut conv's."""
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.parallel import sharding

    c, o, min_channels = case["conv"]
    convs = [layers.QConv(c, o, min_channels=min_channels) for _ in range(2)]
    for conv in convs:
        conv.load_state_dict(case["state"])
    plan = sharding.shard_params(convs[1], world, 1)
    convs[1].load_state_dict(sharding.shard_state_dict(case["state"], plan, world))
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        ys = [conv(x) for conv in convs]
    return {"y": ys[1], "y_full": ys[0], "local_out": convs[1].weight.shape[0],
            "quantizes": convs[1].quantizes(),
            "sharded": sorted(sharding.sharded_parameters(convs[1]))}


KINDS = {"gan": gan_case, "csmgan": gan_case, "wave": wave_case, "grouped": wave_case,
         "zoo": zoo_case, "serving": serving_case, "gate": gate_case}


def main(spec_path, out_path):
    torch.set_num_threads(1)
    from use_tpu_torch.parallel.mesh import init_distributed, make_mesh

    assert init_distributed()
    spec = torch.load(spec_path, weights_only=False)
    world = make_mesh(data=2, model=2)
    out = {"rank": torch.distributed.get_rank(), "data_rank": world.rank,
           "model_rank": world.model_rank, "shape": world.shape}
    for case in spec["cases"]:
        run = KINDS.get(case.get("kind"), step_case)
        out[case["name"]] = run(spec, case, world)
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
