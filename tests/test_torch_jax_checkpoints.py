"""use_tpu's checkpoints served by the port: use_tpu writes an Orbax params
directory and a CheckpointManager training directory (SGMSE_debug, with EMA
weights, and LSGAN_debug, with its discriminator),
scripts/export_use_tpu_params.py dumps each to a flat .npz through use_tpu's
own loader, and the port's `predict ckpt_path=<x>.npz` (infer.N=1) writes
what use_tpu's `predict ckpt_path=<the directory>` writes.

The SGMSE sampler draws noise: the port's run replays use_tpu's draws
(cli/main.py: PRNGKey(train.seed), split per file; the PC sampler's splits
per step, as tests/helpers/torch_parity.py::jax_pc_noise gives them).
Tolerance: rtol 1e-4 / atol 1e-5 x max|ref| on the wavs, as
test_torch_chain.py holds a sampled stage (the same arithmetic in another
framework); the exported arrays are bit-equal to the saved params.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers.torch_parity import jax_pc_noise, random_params
from tests.test_torch_train import _two_torch_threads  # noqa: F401 (fixture)
from use_tpu.cli.main import _build_model as jbuild, main as jmain
from use_tpu.config.config import load_config as jload_config
from use_tpu.engine import optim as joptim
from use_tpu.engine.checkpoint import CheckpointManager as JManager, save_params
from use_tpu.engine.state import GANTrainState, TrainState as JTrainState
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.engine.convert_jax import export_meta, load_flat_params
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
FILES = {os.path.join("sub", "a.wav"): 7000}
EMA = ("train.ema_decay=0.999",)


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_use_tpu_params", os.path.join(REPO, "scripts", "export_use_tpu_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    rng = np.random.default_rng(0)
    for rel, n in FILES.items():
        write_wav(str(root / "in" / rel), (0.1 * rng.standard_normal(n)).astype(np.float32), SR)
    return root


def _train_state(params, t, ema=None):
    tx = joptim.adam(t.get("lr", 5e-4), t.get("weight_decay", 1e-7),
                     grad_clip=t.get("grad_clip", 100.0), params_example=params)
    state = JTrainState.create(params, tx, ema_decay=0.999 if ema is not None else 0.0)
    return state if ema is None else state.replace(ema_params=ema)


@pytest.fixture(scope="module")
def checkpoints(wav_tree):
    """use_tpu's two layouts for SGMSE_debug (params; training state with
    EMA weights other than its params) and LSGAN_debug (generator params;
    a GANTrainState with its discriminator), random weights; -> their
    directories and the params they hold."""
    out = {}
    cfg = jload_config("SGMSE_debug", list(EMA))
    model = jbuild(cfg)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    params, ema = random_params(shapes, seed=1), random_params(shapes, seed=2)
    save_params(str(wav_tree / "sgmse_params"), params)
    mgr = JManager(str(wav_tree / "sgmse_run"), monitor="val/loss_Score")
    mgr.save(0, _train_state(params, cfg["train"], ema), {"val/loss_Score": 1.0})
    mgr.close()
    out["sgmse"] = dict(params=params, ema=ema)

    cfg = jload_config("LSGAN_debug", [])
    model = jbuild(cfg)
    g_shapes, d_shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    g, d = random_params(g_shapes, seed=3), random_params(d_shapes, seed=4)
    g = jax.tree.map(lambda a: 0.5 * a, g)  # keeps the wavs inside [-1, 1]
    save_params(str(wav_tree / "lsgan_params"), g)
    t = cfg["train"]
    state = GANTrainState(
        g=JTrainState.create(g, joptim.adam(t["g_lr"], t["weight_decay"], params_example=g)),
        d=JTrainState.create(d, joptim.adam(t["d_lr"], t["weight_decay"], params_example=d)))
    mgr = JManager(str(wav_tree / "lsgan_run"))
    mgr.save(0, state)
    mgr.close()
    out["lsgan"] = dict(params=g, d=d)
    return out


def _export(root, experiment, ckpt, name, *extra):
    return _exporter().export([f"experiment={experiment}", f"ckpt_path={root / ckpt}",
                               f"out={root / name}", *extra])


def _outputs(root, out):
    return {rel: read_wav(str(root / out / rel))[0] for rel in FILES}


def _jax_predict(root, experiment, ckpt, out, *extra):
    jmain(["predict", f"experiment={experiment}", f"ckpt_path={root / ckpt}", "infer.N=1",
           f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}", *extra])
    return _outputs(root, out)


def _port_predict(root, experiment, ckpt, out, *extra):
    main(["predict", f"experiment={experiment}", f"ckpt_path={root / ckpt}", "infer.N=1",
          "device=cpu", f"predict.data_folder={root / 'in'}",
          f"predict.target_folder={root / out}", *extra])
    return _outputs(root, out)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's SGMSE sampler on use_tpu predict's draws: one key per
    file, split from PRNGKey(train.seed)."""
    rng = jax.random.PRNGKey(jload_config("SGMSE_debug", [])["train"]["seed"])
    real = TScoreModel.sample

    def sample(self, batch, generator=None, N=50, corrector_steps=1, **kw):
        nonlocal rng
        rng, sub = jax.random.split(rng)
        draws = []

        def noise_fn(shape):
            if not draws:
                draws.extend(jax_pc_noise(sub, N, tuple(shape), corrector_steps)[::-1])
            return torch.from_numpy(draws.pop())

        return real(self, batch, noise_fn=noise_fn, N=N, corrector_steps=corrector_steps, **kw)

    monkeypatch.setattr(TScoreModel, "sample", sample)


def _assert_holds(npz, params):
    flat = _exporter().flatten(params)
    got = _exporter().flatten(load_flat_params(str(npz)))
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("layout", ["params", "run"])
def test_sgmse_checkpoint_exported_and_served(wav_tree, checkpoints, jax_draws, layout):
    """The params directory, and the training directory's EMA weights; the
    training directory's own params export too (bit-equal, not served
    again: its route is the params directory's)."""
    extra = ("ckpt.use_ema=true",) if layout == "run" else ()
    name = f"sgmse_{layout}.npz"
    meta = _export(wav_tree, "SGMSE_debug", f"sgmse_{layout}", name, *EMA, *extra)
    assert (meta["task"], meta["generator"], meta["ema"], meta["discriminator"]) == (
        "sgmse", None, layout == "run", False)
    assert export_meta(str(wav_tree / name)) == {k: meta[k] for k in (
        "experiment", "task", "generator", "ema", "discriminator")}
    _assert_holds(wav_tree / name, checkpoints["sgmse"]["ema" if extra else "params"])
    if layout == "run":
        _export(wav_tree, "SGMSE_debug", "sgmse_run", "sgmse_run_params.npz", *EMA)
        _assert_holds(wav_tree / "sgmse_run_params.npz", checkpoints["sgmse"]["params"])
        with pytest.raises(SystemExit, match="no EMA params"):
            _port_predict(wav_tree, "SGMSE_debug", "sgmse_run_params.npz", "port_bad",
                          "ckpt.use_ema=true")
        with pytest.raises(SystemExit, match="exported for task 'sgmse'"):
            _port_predict(wav_tree, "LSGAN_debug", name, "port_bad")

    want = _jax_predict(wav_tree, "SGMSE_debug", f"sgmse_{layout}", f"jax_{layout}", *EMA,
                        *extra)
    port = _port_predict(wav_tree, "SGMSE_debug", name, f"port_{layout}", *extra)
    for rel in FILES:
        assert port[rel].shape == (FILES[rel],) and np.isfinite(port[rel]).all()
        _close(port[rel], want[rel])


@pytest.fixture(scope="module")
def lsgan_exports(wav_tree, checkpoints):
    """use_tpu's two LSGAN_debug layouts exported, and the port's predict of
    the training directory's export, run once for the tests that read it;
    -> (the two exports' metadata, the port's outputs)."""
    metas = {name: _export(wav_tree, "LSGAN_debug", name, f"{name}.npz")
             for name in ("lsgan_run", "lsgan_params")}
    return metas, _port_predict(wav_tree, "LSGAN_debug", "lsgan_run.npz", "port_lsgan")


def test_lsgan_checkpoint_exported_and_served(wav_tree, checkpoints, lsgan_exports):
    """The training directory (generator and discriminator) served against
    use_tpu's predict of it; the params directory's export holds the same
    generator arrays."""
    metas, port = lsgan_exports
    meta = metas["lsgan_run"]
    assert (meta["task"], meta["generator"], meta["discriminator"]) == (
        "lsgan", "ncsnpp_wrapper", True)
    loaded = load_flat_params(str(wav_tree / "lsgan_run.npz"))
    _assert_holds(wav_tree / "lsgan_run.npz", {**checkpoints["lsgan"]["params"],
                                               "D": checkpoints["lsgan"]["d"]})
    assert not metas["lsgan_params"]["discriminator"]
    _assert_holds(wav_tree / "lsgan_params.npz", checkpoints["lsgan"]["params"])
    assert "D" in loaded
    want = _jax_predict(wav_tree, "LSGAN_debug", "lsgan_run", "jax_lsgan")
    for rel in FILES:
        assert port[rel].shape == (FILES[rel],) and np.isfinite(port[rel]).all()
        _close(port[rel], want[rel])


def test_lenient_load_of_an_export_skips_leaves(wav_tree, lsgan_exports):
    """An export missing two leaves: strict loads refuse it, ckpt.lenient=true
    keeps the port's own initialization of those two and serves the rest,
    unlike the full export's (lsgan_exports' predict of the training
    directory's export, which holds the same generator arrays)."""
    full = lsgan_exports[1]
    with np.load(wav_tree / "lsgan_params.npz") as flat:
        arrays = {k: flat[k] for k in flat.files}
    dropped = [k for k in arrays if k.endswith("GroupNorm_0/scale")][:2]
    assert len(dropped) == 2
    np.savez(wav_tree / "lsgan_partial.npz", **{k: v for k, v in arrays.items()
                                                if k not in dropped})
    with pytest.raises(RuntimeError, match="Missing key"):
        _port_predict(wav_tree, "LSGAN_debug", "lsgan_partial.npz", "port_strict")
    port = _port_predict(wav_tree, "LSGAN_debug", "lsgan_partial.npz", "port_lenient",
                         "ckpt.lenient=true")
    for rel in FILES:
        assert np.isfinite(port[rel]).all() and not np.array_equal(port[rel], full[rel])


@pytest.mark.parametrize("cfg", [
    dict(nf=16, ch_mult=(1, 2)),
    dict(nf=16, ch_mult=(1, 2), resblock_type="ddpm", progressive="residual",
         progressive_input="residual"),
    dict(nf=16, ch_mult=(1, 2), discriminative=True),
], ids=["biggan", "ddpm_residual", "discriminative"])
def test_chip_smoke_flax_flat_inverts_the_converter(cfg):
    """chip_smoke writes its .npz (the card's machine has no JAX) with
    flax_flat, which must give use_tpu's flat naming and layouts of the
    same weights, as the exporter does, key for key and bit for bit."""
    import chip_smoke
    from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
    from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict

    x0 = np.zeros((1, 16, 16, 2 if cfg.get("discriminative") else 4), np.float32)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**cfg)).init, jax.random.PRNGKey(0), x0,
                            None if cfg.get("discriminative") else np.full((1,), 0.5,
                                                                           np.float32))
    params = random_params(shapes["params"], seed=11)
    want = _exporter().flatten(params)
    got = chip_smoke.flax_flat(ncsnpp_params_to_state_dict(params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


class _Stop(Exception):
    pass


def test_train_starts_from_an_export_with_its_discriminator(wav_tree, checkpoints, lsgan_exports,
                                                            monkeypatch):
    """`train ckpt_path=<x>.npz` initializes the model from the export (an
    LSGAN training directory's: G and D) instead of resuming; `eval` loads
    the same D (``_load_discriminator``)."""
    from use_tpu_torch.cli import main as cli
    from use_tpu_torch.engine import loop
    from use_tpu_torch.engine.convert_jax import (
        discriminator_params_to_state_dict, lsgan_params_to_state_dict)

    seen = {}

    def fit(model, dm, **kw):
        seen.update(model=model, resume=kw["resume"])
        raise _Stop

    monkeypatch.setattr(cli, "_build_datamodule", lambda cfg: None)
    monkeypatch.setattr(loop, "fit_lsgan", fit)
    with pytest.raises(_Stop):
        main(["train", "experiment=LSGAN_debug", "device=cpu",
              f"ckpt_path={wav_tree / 'lsgan_run.npz'}", f"out_dir={wav_tree / 'train_run'}"])
    assert seen["resume"] is False
    want = {"g": lsgan_params_to_state_dict(checkpoints["lsgan"]["params"]),
            "d": discriminator_params_to_state_dict(checkpoints["lsgan"]["d"])}
    got = {"g": seen["model"].generator.net.state_dict(),
           "d": seen["model"].discriminator.state_dict()}
    for part in ("g", "d"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, rtol=0, atol=0)
    model = cli._build_model(cli.load_config("LSGAN_debug", []), "cpu")
    assert cli._load_discriminator(model, str(wav_tree / "lsgan_run.npz"))
    for k, v in want["d"].items():
        torch.testing.assert_close(model.discriminator.state_dict()[k], v, rtol=0, atol=0)
