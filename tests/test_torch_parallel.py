"""Data-parallel training of use_tpu_torch (parallel/mesh.py, DDP in the
engine) against use_tpu's mesh, on the CPU.

The rule of the world (``default_world`` against ``default_mesh``, the
error's text included), ``resolve_auto_batch`` over device counts, the
datamodule's per-rank batches (bit for bit), and two gloo ranks
(tests/helpers/torch_ddp_worker.py, which imports the port only) that
take one sgmse_train_step and one gan_train_step over their halves of a
global batch: both ranks end bit-identical, and their step equals
use_tpu's over the whole batch (use_tpu's own draws replayed, as in
tests/test_torch_train.py; the same tolerances: gradients within 1e-3
relative plus 1e-4 of each tensor's largest, parameters after Adam within
rtol 1e-5, atol 1e-7 where the gradient is not within rounding of 0).
Also: a 2-rank fit_sgmse (loader batches of different lengths a rank,
accumulation 2, two epochs, validation, an asynchronous checkpoint from
rank 0) equals the one-process fit over the ranks' batches side by side,
and a CSMGAN generator (a parameter reaching no output) steps under DDP.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import random_params
from use_tpu.cli.main import resolve_auto_batch as jresolve
from use_tpu.data import datamodule as jdm, distort_dataset as jdd
from use_tpu.engine import optim as joptim
from use_tpu.engine.state import GANTrainState as JGANState, TrainState as JTrainState
from use_tpu.engine.train import _accum_grads, make_gan_train_step, make_sgmse_train_step
from use_tpu.parallel.mesh import default_mesh
from use_tpu_torch.cli import main as cli
from use_tpu_torch.data import datamodule as tdm, distort_dataset as tdd
from use_tpu_torch.engine.convert_jax import (
    discriminator_params_to_state_dict,
    lsgan_params_to_state_dict,
    ncsnpp_params_to_state_dict,
)
from use_tpu_torch.engine import loop
from use_tpu_torch.engine.loop import fit_sgmse
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel
from use_tpu_torch.parallel import mesh as tmesh
from tests.helpers.torch_ddp_worker import RankBatches
from tests.test_torch_gan_train import (
    CLIP, GEN, STEP_LOSS, JTinyD, _adam_step_close, _grads_close)
from tests.test_torch_train import TINY, TINY_KWARGS, TINY_LEN, jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
LR = 1e-3
CSMGAN = dict(n_fft=96, win_length=96, hop_length=48, input_freq=48,
              encoder_channels=(4, 4, 8), encoder_depths=(1, 1), decoder_depths=(1, 1),
              tcn_input_dim=96, tcn_bn_dim=32, tcn_hidden_dim=32, tcn_layers=2,
              tcn_stacks=1, in_proj_channels=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the rule of the world -------------------------------------------------

@pytest.mark.parametrize("batch,world,on_idle", [
    (8, 8, "error"), (4, 8, "error"), (2, 8, "error"), (2, 8, "warn"), (6, 4, "warn"),
    (6, 4, "error"), (3, 2, "error"), (1, 1, "error"), (5, 8, "warn")])
def test_default_world_matches_default_mesh(batch, world, on_idle):
    """The ranks that train are use_tpu's data axis over `world` devices;
    where use_tpu refuses, the port raises the same message."""
    devices = jax.devices()[:world]
    assert len(devices) == world
    try:
        want = default_mesh(batch, devices=devices, on_idle=on_idle).shape["data"]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.default_world(batch, world=world, on_idle=on_idle)
        assert str(got.value) == str(e)
        return
    w = tmesh.default_world(batch, world=world, on_idle=on_idle)
    assert w.size == want and w.trains and w.rank == 0 and not w.distributed


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("data,train", [
    ({"batch_size": "auto", "micro_batch_per_device": 2},
     {"accumulate_grad_batches": "auto", "effective_batch": 8}),
    ({"batch_size": "auto", "micro_batch_per_device": 1}, {"accumulate_grad_batches": 4}),
    ({"batch_size": 2}, {"accumulate_grad_batches": "auto"}),
])
def test_resolve_auto_batch_scales_with_the_devices_as_jax(n, data, train):
    """The port's repair: the global batch of 'auto' grows with the devices
    (it stayed at one device's), the accumulation shrinks, as use_tpu's."""
    got = {"data": dict(data), "train": dict(train)}
    want = {"data": dict(data), "train": dict(train)}
    cli.resolve_auto_batch(got, n)
    jresolve(want, n)
    assert got == want


def test_init_distributed_is_a_noop_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_cmd_train_reads_async_ckpt_and_mesh_idle(monkeypatch, tmp_path):
    """The port's repair: train.async_ckpt reaches the fit, and under a
    process group train.mesh_idle (SGMSE_debug's 'warn'; 'error' where the
    config has none, as use_tpu's CLI) and the world-scaled global batch
    reach the world's rule."""
    seen = {}

    class Stop(Exception):
        pass

    def fit(model, dm, **kw):
        seen.update(kw, local_batch=dm.local_batch)
        raise Stop

    monkeypatch.setattr(loop, "fit_sgmse", fit)
    base = ["train", "experiment=SGMSE_debug", "device=cpu", f"out_dir={tmp_path}",
            "data.clean_json_path=x.jsonl", "data.noise_json_path=x.jsonl"]
    with pytest.raises(Stop):
        cli.main(base + ["train.async_ckpt=true"])
    assert seen["async_ckpt"] is True and seen["mesh"].size == 1
    with pytest.raises(Stop):
        cli.main(base)
    assert seen["async_ckpt"] is False

    rules = []

    def world(global_batch, world=None, on_idle="warn"):
        rules.append((global_batch, on_idle))
        return tmesh.World(size=1, rank=1, trains=False)

    monkeypatch.setattr(tmesh, "init_distributed", lambda backend=None: True)
    monkeypatch.setattr(tmesh, "default_world", world)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(torch.distributed, "destroy_process_group", lambda group=None: None)
    auto = ["data.batch_size=auto", "data.micro_batch_per_device=2"]
    for argv, want in ((base, "warn"), (base + ["train.mesh_idle=error"], "error"),
                       ([a.replace("SGMSE_debug", "SGMSE_Large") for a in base], "error")):
        out = cli.main(argv + auto)
        assert rules[-1] == (8, want) and "history" not in out  # an idle rank trains nothing


# -- the datamodule's ranks ------------------------------------------------

@pytest.fixture
def corpus(tmp_path):
    from use_tpu.data import synth_speech as jsynth
    from use_tpu_torch.data.audio_io import write_wav

    jl = tmp_path / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(4):
            clean, _ = jsynth.synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    return str(jl)


def _cfg(mod, jl):
    return mod.DistortConfig(clean_json_path=jl, noise_json_path=jl, reverb_use_FRA=True,
                             min_duration_seconds=0.1, speech_splice_seconds=1)


@pytest.mark.parametrize("rank", [0, 1])
def test_datamodule_rank_batches_bit_equal(corpus, rank):
    """World 2: the rank's first train and validation batches (local batch
    2 of the global 4, its seeds mixed with the rank) equal use_tpu's
    DistortDataModule(world_size=2, process_index=rank) bit for bit; its
    loaders' seeds are use_tpu's, seed + 1_000_003 x rank (+1, +2)."""
    import random

    kw = dict(batch_size=4, num_workers=0, seed=11, world_size=2)

    def first(mod, dm, r):
        m = dm.DistortDataModule(train_cfg=_cfg(mod, corpus), process_index=r, **kw)
        random.seed(3)
        np.random.seed(3)
        return next(iter(m.train_dataloader())), next(iter(m.val_dataloader())), m

    *want, jm = first(jdd, jdm, rank)
    *got, tm = first(tdd, tdm, rank)
    assert tm.local_batch == jm.local_batch == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v)
    seeds = (tm.train_dataloader().seed, tm.val_dataloader().seed, tm.test_dataloader().seed)
    assert seeds == tuple(11 + 1_000_003 * rank + i for i in range(3))
    with pytest.raises(AssertionError):
        tdm.DistortDataModule(train_cfg=_cfg(tdd, corpus), batch_size=3, world_size=2)


# -- two gloo ranks --------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(seed, n=2, length=CLIP):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((n, length))).astype(np.float32)
    return {"clean": clean,
            "perturbed": (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)}


def _fit_batches(rank, n, length, seed):
    """`n` batches of 1 clip for a rank, the lengths differing by rank."""
    return [_batch(seed + 10 * rank + i, n=1, length=length + 37 * rank - 11 * i)
            for i in range(n)]


def _side_by_side(per_rank):
    """The one-process batches: each of the ranks' batches zero-padded to
    the longest of them, concatenated in rank order."""
    out = []
    for batches in zip(*per_rank):
        top = max(b["clean"].shape[-1] for b in batches)
        out.append({k: np.concatenate([np.pad(b[k], ((0, 0), (0, top - b[k].shape[-1])))
                                       for b in batches]) for k in batches[0]})
    return out


@pytest.fixture(scope="module")
def tiny_sgmse():
    from use_tpu.models.sgmse.score_model import ScoreModel as JScoreModel

    jm = JScoreModel(**TINY, backbone_kwargs=TINY_KWARGS)
    params = random_params(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=6)
    return jm, params


@pytest.fixture(scope="module")
def tiny_gan():
    from use_tpu.models.gan import losses as jlosses
    from use_tpu.models.gan.generator import NCSNPPWrapper as JGenerator
    from use_tpu.models.gan.lsgan import LSGAN as JLSGAN

    jgan = JLSGAN(generator=JGenerator(**GEN), discriminator=JTinyD(),
                  g_loss_cfg=jlosses.HifiganGLossConfig(**STEP_LOSS))
    g_shape, d_shape = jax.eval_shape(lambda: jgan.init_params(jax.random.PRNGKey(0), CLIP))
    return jgan, random_params(g_shape, seed=1), random_params(d_shape, seed=2)


@pytest.fixture(scope="module")
def ddp_run(tiny_sgmse, tiny_gan, tmp_path_factory):
    """The spec of every case, two worker ranks run on it (gloo), and their
    outputs."""
    tmp = tmp_path_factory.mktemp("ddp")
    jm, params = tiny_sgmse
    jgan, g_params, d_params = tiny_gan
    micro = [_batch(10 + i, length=TINY_LEN) for i in range(2)]
    rngs = list(jax.random.split(jax.random.PRNGKey(3), 2))
    gmicro = [_batch(20 + i) for i in range(2)]
    grngs = list(jax.random.split(jax.random.PRNGKey(4), 2))
    model = dict(TINY, backbone_kwargs=TINY_KWARGS)
    sd = ncsnpp_params_to_state_dict(params)
    fit_train = [_fit_batches(r, 4, TINY_LEN, 40) for r in range(2)]
    fit_val = [_fit_batches(r, 1, TINY_LEN, 60) for r in range(2)]
    spec = {
        "sgmse": {"model": model, "state_dict": sd, "lr": LR, "micro": micro,
                  "draws": [jax_draws(jm, r, m) for r, m in zip(rngs, micro)]},
        "gan": {"generator": GEN, "g_state_dict": lsgan_params_to_state_dict(g_params),
                "d_state_dict": discriminator_params_to_state_dict(d_params),
                "g_loss": STEP_LOSS, "g_lr": 5e-4, "d_lr": 2e-4, "micro": gmicro,
                "starts": [int(jax.random.randint(r, (), 0, CLIP - 496)) for r in grngs]},
        "fit": {"model": model, "state_dict": sd, "lr": LR, "train": fit_train,
                "val": fit_val, "local_batch": 1, "ckpt_dir": str(tmp / "ckpt")},
        "csmgan": {"generator": CSMGAN, "g_lr": 5e-4, "d_lr": 2e-4,
                   "micro": [_batch(30, length=4800)]},
    }
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "PYTHONPATH": REPO,
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.helpers.torch_ddp_worker", spec_path,
             str(tmp / f"rank{rank}.pt")], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return spec, outs, tmp


def _identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_ranks_join_through_init_distributed(ddp_run):
    _, outs, _ = ddp_run
    assert [(o["rank"], o["world"], o["backend"]) for o in outs] == [(0, 2, "gloo"),
                                                                  (1, 2, "gloo")]


def test_two_rank_sgmse_step_matches_jax(ddp_run, tiny_sgmse):
    """Accumulation 2 (the first microbatch under no_sync): the gradient
    the ranks apply is use_tpu's group mean over the global batch, the
    loss its loss, and the parameters after clip + Adam its step's; both
    ranks bit-identical."""
    spec, outs, _ = ddp_run
    jm, params = tiny_sgmse
    for part in ("grads", "params"):
        _identical(outs[0]["sgmse"][part], outs[1]["sgmse"][part])
    assert outs[0]["sgmse"]["loss"] == outs[1]["sgmse"]["loss"]
    s = spec["sgmse"]
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in s["micro"]]) for k in s["micro"][0]}
    rng = jax.random.PRNGKey(3)
    loss_j, _, grads_j = jax.jit(lambda p, b, r: _accum_grads(
        lambda p, b, r: (jm.train_loss(p, b, r), {}), p, b, r, 2))(params, stacked, rng)
    tx = joptim.adam(LR, 1e-7, grad_clip=100.0, params_example=params)
    new, _ = make_sgmse_train_step(jm, tx, accum=2, donate=False)(
        JTrainState.create(params, tx), stacked, rng)
    out = outs[0]["sgmse"]
    assert abs(out["loss"] - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    grads_j = ncsnpp_params_to_state_dict(jax.device_get(grads_j))
    grads_j.pop("all_modules.0.W")  # frozen: use_tpu's stop_gradient
    _grads_close(out["grads"], grads_j)
    want = ncsnpp_params_to_state_dict(jax.device_get(new.params))
    net = TScoreModel(**spec["sgmse"]["model"], device="cpu").score_net
    net.load_state_dict(out["params"])
    torch.testing.assert_close(net.all_modules[0].W, torch.as_tensor(want.pop(
        "all_modules.0.W")), rtol=0, atol=0)  # frozen: untouched by the step
    net.all_modules[0].W = None  # _adam_step_close walks the trained parameters
    _adam_step_close(net, want, grads_j, LR)


def test_two_rank_gan_step_matches_jax(ddp_run, tiny_gan):
    """Accumulation 2: D's and G's summed gradients (D on the fake of G's
    own module, G against the stepped D's own module), the losses and both
    networks after their Adam steps are use_tpu's over the global batch;
    both ranks bit-identical."""
    spec, outs, _ = ddp_run
    jgan, g_params, d_params = tiny_gan
    for part in ("d_grads", "g_grads", "d_params", "g_params"):
        _identical(outs[0]["gan"][part], outs[1]["gan"][part])
    assert outs[0]["gan"]["metrics"] == outs[1]["gan"]["metrics"]
    s = spec["gan"]
    g_tx = joptim.adam(5e-4, 1e-7, params_example=g_params)
    d_tx = joptim.adam(2e-4, 1e-7, params_example=d_params)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in s["micro"]]) for k in s["micro"][0]}
    rng = jax.random.PRNGKey(4)
    new, metrics = make_gan_train_step(jgan, g_tx, d_tx, accum=2, donate=False)(
        JGANState(g=JTrainState.create(g_params, g_tx), d=JTrainState.create(d_params, d_tx)),
        stacked, rng)

    @jax.jit
    def grads(gp, dp, new_dp, mb, r):
        fake = jax.lax.stop_gradient(jgan.g_forward(gp, mb, r))
        return (jax.grad(jgan.d_loss)(dp, fake),
                jax.grad(lambda p: jgan.g_loss(new_dp, jgan.g_forward(p, mb, r))[0])(gp))

    gd_j = jax.tree.map(jnp.zeros_like, d_params)
    gg_j = jax.tree.map(jnp.zeros_like, g_params)
    for mb, r in zip(s["micro"], jax.random.split(rng, 2)):
        gd, gg = grads(g_params, d_params, new.d.params,
                       {k: jnp.asarray(v) for k, v in mb.items()}, r)
        gd_j, gg_j = jax.tree.map(jnp.add, gd_j, gd), jax.tree.map(jnp.add, gg_j, gg)
    out = outs[0]["gan"]
    for k, v in out["metrics"].items():
        tol = 1e-3 if k == "loss_G" else 1e-4
        assert abs(v - float(metrics[k])) <= tol * abs(float(metrics[k])), k
    gd_j = discriminator_params_to_state_dict(jax.device_get(gd_j))
    gg_j = lsgan_params_to_state_dict(jax.device_get(gg_j))
    _grads_close(out["d_grads"], gd_j)
    _grads_close(out["g_grads"], gg_j)
    from tests.helpers.torch_ddp_worker import TinyD
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper

    d, gen = TinyD(), NCSNPPWrapper(**GEN, device="cpu")
    d.load_state_dict(out["d_params"])
    gen.net.load_state_dict(out["g_params"])
    _adam_step_close(d, discriminator_params_to_state_dict(jax.device_get(new.d.params)),
                     gd_j, 2e-4)
    _adam_step_close(gen.net, lsgan_params_to_state_dict(jax.device_get(new.g.params)),
                     gg_j, 5e-4)


def test_two_rank_fit_equals_the_one_process_fit(ddp_run):
    """fit_sgmse at world 2 (each rank its loader's batches of 1 clip, of
    lengths that differ by rank, accumulation 2, 2 epochs, validation) and
    at world 1 over the ranks' batches side by side: the same steps, clips,
    losses (rtol 1e-5) and parameters after 4 Adam steps: all but 1e-4 of
    the elements within rtol 1e-5 plus 1e-7, every one within 2 lr a step,
    the attention's key biases apart (their gradient is 0 in exact
    arithmetic, so Adam moves them by the sign of rounding). Adam's update
    lr m / (sqrt(v) + eps) moves by lr times m's relative rounding, large
    where m cancels over the steps: the one-process fit on one torch thread
    against two differs as much (3 of 1.8e5 elements off, by up to 1.1e-6,
    and 32 key biases). Rank 0's asynchronous checkpoint holds the final
    parameters."""
    spec, outs, tmp = ddp_run
    _identical(outs[0]["fit"]["params"], outs[1]["fit"]["params"])
    s = spec["fit"]
    model = TScoreModel(**s["model"], device="cpu")
    model.score_net.load_state_dict(s["state_dict"])
    dm = RankBatches(_side_by_side(s["train"]), _side_by_side(s["val"]), 2)
    res = fit_sgmse(model, dm, lr=LR, accumulate_grad_batches=2, max_epochs=2, mesh=None)
    got = outs[0]["fit"]
    assert got["steps"] == res.steps == 4 and got["clips"] == res.clips == 16
    for g, w in zip(got["history"], res.history):
        for k in ("train/loss_Score", "val/loss_Score"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), k
    key_biases = {f"{n}.NIN_1.b" for n, m in model.score_net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    off = total = 0
    for k, p in model.score_net.named_parameters():
        diff = (got["params"][k] - p.detach()).abs()
        assert float(diff.max()) <= 2 * LR * res.steps, k
        if k not in key_biases:
            off += int((diff > 1e-7 + 1e-5 * p.detach().abs()).sum())
            total += p.numel()
    assert off <= 1e-4 * total, (off, total)
    state = torch.load(os.path.join(s["ckpt_dir"], "1", "state.pt"), weights_only=True)
    _identical({k: state["model"][k] for k in got["params"]}, got["params"])
    assert sorted(os.listdir(s["ckpt_dir"])) == ["0", "1"]


def test_csmgan_generator_steps_under_ddp(ddp_run):
    """CSMGAN's last res_out reaches no output: with
    ``ddp_find_unused_parameters`` the step runs, both ranks bit-identical
    and finite."""
    _, outs, _ = ddp_run
    for part in ("g_params", "d_params"):
        _identical(outs[0]["csmgan"][part], outs[1]["csmgan"][part])
        assert all(bool(torch.isfinite(v).all()) for v in outs[0]["csmgan"][part].values())
