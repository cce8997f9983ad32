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
"""
import contextlib
import sys

import torch


def _gathered(net, grads, world):
    """{name: the whole tensor} of a {name: this rank's tensor} of `net`'s
    parameters, the slices gathered over the model group."""
    from use_tpu_torch.parallel import sharding

    sliced = sharding.sharded_parameters(net)
    return {k: sharding.model_all_gather(v, 0, world.model_group.group_name, world.model)
            if k in sliced else v for k, v in grads.items()}


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


def main(spec_path, out_path):
    torch.set_num_threads(1)
    from use_tpu_torch.parallel.mesh import init_distributed, make_mesh

    assert init_distributed()
    spec = torch.load(spec_path, weights_only=False)
    world = make_mesh(data=2, model=2)
    out = {"rank": torch.distributed.get_rank(), "data_rank": world.rank,
           "model_rank": world.model_rank, "shape": world.shape}
    for case in spec["cases"]:
        out[case["name"]] = step_case(spec, case, world)
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
