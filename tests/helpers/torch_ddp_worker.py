"""One rank of the port's 2-process data-parallel CPU checks.

Launched twice by tests/test_torch_parallel.py with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); imports torch and
use_tpu_torch only. ``python -m tests.helpers.torch_ddp_worker <spec.pt>
<out.pt>``: joins the gloo group through ``init_distributed``, runs each
case of the spec on this rank's share and saves what the parent compares:

- ``sgmse``: one sgmse_train_step over the global microbatches' rows of
  this rank, on the given global draws (the gradients it applies, the
  parameters after the step, the reported loss);
- ``gan``: one gan_train_step on the given crop starts (D's and G's
  gradients and parameters, the reported losses);
- ``fit``: fit_sgmse over this rank's batches (``RankBatches``), with an
  asynchronous checkpoint that rank 0 writes (parameters, history);
- ``csmgan``: one gan_train_step of a CSMGAN generator, whose last TCN
  block's res_out reaches no output (the parameters after it).
"""
import os
import sys

import numpy as np
import torch


class TinyD(torch.nn.Module):
    """The period bank at 2 and 3 and one mel discriminator (the D of
    tests/test_torch_gan_train.py)."""

    def __init__(self):
        super().__init__()
        from use_tpu_torch.models.gan import discriminators as tdisc

        period = dict(channels=8, max_downsample_channels=32)
        self.period2 = tdisc.PeriodDiscriminator(period=2, **period)
        self.period3 = tdisc.PeriodDiscriminator(period=3, **period)
        self.mel0 = tdisc.MelspecDiscriminator(n_fft=256, win_length=240, hop_length=60,
                                               n_mels=64)

    def forward(self, x):
        per = [self.period2(x), self.period3(x)]
        lm, fm = self.mel0(x)
        return [[o[0] for o in per], [lm]], [[o[1] for o in per], [fm]]


class RankBatches:
    """A datamodule of fixed batches: ``train`` and ``val`` lists of float
    batch dicts (numpy), the same on every call."""

    def __init__(self, train, val, local_batch):
        self.train, self.val, self.local_batch = train, val, local_batch

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return list(self.val)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rows(batch, world):
    n = len(next(iter(batch.values()))) // world.size
    return {k: v[world.rank * n:(world.rank + 1) * n] for k, v in batch.items()}


def _recording(state, seen, name):
    real = state.apply_gradients

    def apply():
        seen[name] = {k: p.grad.clone() for k, p in state.model.named_parameters()
                      if p.grad is not None}
        real()

    state.apply_gradients = apply


def _params(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def sgmse_case(spec, world):
    from use_tpu_torch.engine import optim
    from use_tpu_torch.engine.state import TrainState
    from use_tpu_torch.engine.train import sgmse_train_step
    from use_tpu_torch.models.sgmse.score_model import ScoreModel
    from use_tpu_torch.parallel.mesh import local_rows, wrap

    model = ScoreModel(**spec["model"], device="cpu")
    model.score_net.load_state_dict(spec["state_dict"])
    net = model.score_net
    state = TrainState.create(net, optim.adam(optim.trainable(net), spec["lr"], 1e-7),
                              grad_clip=100.0)
    state.world, state.ddp = world, wrap(net, world, torch.device("cpu"))
    seen = {}
    _recording(state, seen, "grads")
    draws = [(s, local_rows(t, world), local_rows(z, world)) for s, t, z in spec["draws"]]
    out = sgmse_train_step(model, state, [_t(_rows(m, world)) for m in spec["micro"]],
                           draws=draws)
    return {"grads": seen["grads"], "params": _params(net), "loss": float(out["loss_Score"])}


def _gan_state(gan, world, spec, find_unused=False):
    from use_tpu_torch.engine.loop import distribute, build_gan_train_state

    state = build_gan_train_state(gan, spec["g_lr"], spec["d_lr"], 1e-7)
    distribute(state.g, world, torch.device("cpu"), find_unused)
    distribute(state.d, world, torch.device("cpu"))
    return state


def gan_case(spec, world):
    from use_tpu_torch.engine.train import gan_train_step
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper
    from use_tpu_torch.models.gan.lsgan import LSGAN

    gen = NCSNPPWrapper(**spec["generator"], device="cpu")
    gen.net.load_state_dict(spec["g_state_dict"])
    d = TinyD()
    d.load_state_dict(spec["d_state_dict"])
    gan = LSGAN(generator=gen, discriminator=d, g_loss_cfg=dict(spec["g_loss"]))
    state = _gan_state(gan, world, spec)
    seen = {}
    _recording(state.d, seen, "d_grads")
    _recording(state.g, seen, "g_grads")
    out = gan_train_step(gan, state, [_t(_rows(m, world)) for m in spec["micro"]],
                         starts=spec["starts"])
    return {**seen, "d_params": _params(d), "g_params": _params(gen.net),
            "metrics": {k: float(v) for k, v in out.items()}}


def fit_case(spec, world):
    from use_tpu_torch.engine.loop import fit_sgmse
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    model = ScoreModel(**spec["model"], device="cpu")
    model.score_net.load_state_dict(spec["state_dict"])
    dm = RankBatches(spec["train"][world.rank], spec["val"][world.rank], spec["local_batch"])
    res = fit_sgmse(model, dm, lr=spec["lr"], accumulate_grad_batches=2, max_epochs=2,
                    ckpt_dir=spec["ckpt_dir"], async_ckpt=True)
    return {"params": _params(model.score_net), "history": res.history, "steps": res.steps,
            "clips": res.clips}


def csmgan_case(spec, world):
    from use_tpu_torch.engine.train import gan_train_step
    from use_tpu_torch.models.gan.csmgan import CSMGANWrapper
    from use_tpu_torch.models.gan.lsgan import LSGAN

    gen = CSMGANWrapper(**spec["generator"], device="cpu", seed=3)
    gan = LSGAN(generator=gen, discriminator=TinyD())
    state = _gan_state(gan, world, spec, find_unused=gen.ddp_find_unused_parameters)
    gan_train_step(gan, state, [_t(_rows(m, world)) for m in spec["micro"]])
    return {"g_params": _params(gen.net), "d_params": _params(gan.discriminator)}


CASES = {"sgmse": sgmse_case, "gan": gan_case, "fit": fit_case, "csmgan": csmgan_case}


def main(spec_path, out_path):
    torch.set_num_threads(1)
    from use_tpu_torch.parallel.mesh import default_world, init_distributed

    assert init_distributed()
    spec = torch.load(spec_path, weights_only=False)
    world = default_world(2 * int(os.environ["WORLD_SIZE"]))
    out = {"rank": world.rank, "world": world.size,
           "backend": torch.distributed.get_backend()}
    for name, case in spec.items():
        out[name] = CASES[name](case, world)
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
