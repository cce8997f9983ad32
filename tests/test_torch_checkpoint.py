"""Checkpoints of the port and the CLI's train -> predict loop, on the CPU.

CheckpointManager (save / restore, best and latest step, max_to_keep),
use_tpu's lenient merge, `train experiment=SGMSE_debug device=cpu` on a
synth_speech corpus (metrics.csv, checkpoints/, optimized_metric.json,
resume), `predict ckpt_path=<out_dir>/checkpoints` with and without
`ckpt.use_ema=true`, and the `ckpt_path` forms: a Lightning-style `.ckpt`
(backbone keys under `Score.score_net.` or `G.net.`) predicts as its bare
state_dict does.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from use_tpu.cli.main import resolve_auto_batch as jresolve
from use_tpu.data.synth_speech import synth_pair
from use_tpu.engine.checkpoint import merge_params_lenient as jmerge
from use_tpu_torch.cli.main import main, resolve_auto_batch
from use_tpu_torch.data.audio_io import read_wav, write_wav
from use_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    load_params,
    merge_params_lenient,
    save_params,
)

SR = 24000


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once; torch's pool of every core in
    each oversubscribes the machine and slows its ops many times over, so
    this module's torch work runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def test_manager_best_latest_and_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3, monitor="val/loss")
    assert mgr.latest_step() is None and mgr.best_step() is None
    for step, loss in enumerate([5.0, 2.0, float("nan"), 3.0, 1.5]):
        mgr.save(step, {"w": torch.full((2,), float(step))}, {"val/loss": loss})
    # the NaN step went first, then the worst finite (5.0)
    assert mgr.steps() == [1, 3, 4]
    assert mgr.latest_step() == 4 and mgr.best_step() == 4
    assert torch.equal(mgr.restore(1)["w"], torch.ones(2))
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 4.0))
    assert mgr.metrics(3) == {"val/loss": 3.0}
    top = CheckpointManager(str(tmp_path / "ck"), monitor="val/loss", mode="max")
    assert top.best_step() == 3
    plain = CheckpointManager(str(tmp_path / "none"))
    plain.save(0, {"w": torch.zeros(1)})
    assert plain.best_step() is None and plain.latest_step() == 0
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_lenient_merge_matches_jax_and_guards_the_skipped_share(tmp_path):
    """Same entries taken and skipped as use_tpu's merge_params_lenient
    (nested there, flat here); a load that skips most of the template raises."""
    tpl = {"a.w": torch.zeros(2, 3), "a.b": torch.zeros(3), "c.w": torch.zeros(4)}
    loaded = {"a.w": torch.ones(2, 3), "a.b": torch.ones(5), "d.w": torch.ones(1)}
    merged, skipped = merge_params_lenient(tpl, loaded)
    assert torch.equal(merged["a.w"], torch.ones(2, 3))
    assert torch.equal(merged["a.b"], torch.zeros(3)) and torch.equal(merged["c.w"], torch.zeros(4))
    nest = lambda d: {"a": {"w": d["a.w"].numpy(), "b": d["a.b"].numpy()},
                      **({"c": {"w": d["c.w"].numpy()}} if "c.w" in d else {}),
                      **({"d": {"w": d["d.w"].numpy()}} if "d.w" in d else {})}
    jmerged, jskipped = jmerge(nest(tpl), nest(loaded))
    def kinds(report):  # (top-level name, why): use_tpu reports a missing subtree once
        return sorted((s.split(" ")[0].replace("/", ".").split(".")[0],
                       s.split("[")[1].split(" ")[0].rstrip("]")) for s in report)

    assert kinds(skipped) == kinds(jskipped) == [("a", "shape"), ("c", "missing"),
                                                 ("d", "loaded-only")]
    np.testing.assert_array_equal(np.asarray(jmerged["a"]["w"]), merged["a.w"].numpy())
    path = str(tmp_path / "p.pt")
    save_params(path, loaded)
    with pytest.raises(ValueError, match="does not match"):
        load_params(path, template=tpl, lenient=True)
    assert torch.equal(load_params(path)["a.b"], torch.ones(5))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of `train experiment=SGMSE_debug device=cpu` with an EMA,
    on four synth_speech clips; -> (root, out_dir, summary)."""
    root = tmp_path_factory.mktemp("train")
    jl = root / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(4):
            clean, _ = synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(root / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    out = str(root / "run")
    summary = main(["train", "experiment=SGMSE_debug", f"data.clean_json_path={jl}",
                    f"data.noise_json_path={jl}", "data.reverb_use_FRA=true",
                    "data.min_duration_seconds=0.1", "data.speech_splice_seconds=1",
                    "data.num_workers=0", "train.max_epochs=1", "train.ema_decay=0.5",
                    f"out_dir={out}", "device=cpu"])
    write_wav(str(root / "in" / "a.wav"),
              (0.1 * np.random.default_rng(0).standard_normal(9000)).astype(np.float32), SR)
    return root, out, summary


def test_cli_train_writes_metrics_checkpoints_and_optimized_metric(trained):
    """As tests/test_cli.py::test_cli_train_smoke holds use_tpu's train."""
    _, out, summary = trained
    assert os.path.exists(os.path.join(out, "metrics.csv"))
    with open(os.path.join(out, "metrics.csv")) as f:
        # epoch rows; the test-after-fit row follows under a header of its own
        epochs = [r for r in csv.DictReader(f) if r["epoch"].isdigit() and r.get("lr")]
    assert len(epochs) == 1 and all(np.isfinite(float(r["train/loss_Score"])) for r in epochs)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["0"]
    with open(os.path.join(out, "optimized_metric.json")) as f:
        rec = json.load(f)
    assert rec["metric"] == "val/loss_Score"
    assert np.isfinite(rec["value"]) and np.isfinite(rec["test"]["test/loss_Score"])
    # 4 clips in batches of 2, accumulation 1: 2 optimizer steps an epoch
    assert summary["optimizer_steps"] == 2 and summary["microbatches"] == 2
    assert summary["clips"] == 4
    state = CheckpointManager(os.path.join(out, "checkpoints")).restore(0)
    assert state["step"] == 2 and state["ema_params"] is not None


def _predict(root, out, *extra):
    main(["predict", "experiment=SGMSE_debug", "device=cpu", "infer.N=2",
          f"predict.data_folder={root / 'in'}", f"predict.target_folder={root / out}", *extra])
    return read_wav(str(root / out / "a.wav"))[0]


def test_predict_serves_the_trained_checkpoint_and_its_ema(trained):
    """ckpt_path=<out_dir>/checkpoints serves the best step's weights, and
    with ckpt.use_ema=true its EMA weights: each equals the same weights
    saved as a bare state_dict."""
    root, out, _ = trained
    ckdir = os.path.join(out, "checkpoints")
    mgr = CheckpointManager(ckdir, monitor="val/loss_Score")
    state = mgr.restore(mgr.best_step())
    for key, extra in (("model", ()), ("ema_params", ("ckpt.use_ema=true",))):
        bare = str(root / f"{key}.pt")
        save_params(bare, state[key])
        got = _predict(root, f"out_{key}", f"ckpt_path={ckdir}", *extra)
        want = _predict(root, f"out_{key}_bare", f"ckpt_path={bare}")
        assert np.isfinite(got).all() and got.shape == (9000,)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(_predict(root, "o1", f"ckpt_path={ckdir}"),
                              _predict(root, "o2", f"ckpt_path={ckdir}", "ckpt.use_ema=true"))
    with pytest.raises(SystemExit, match="EMA"):
        _predict(root, "o3", f"ckpt_path={root / 'model.pt'}", "ckpt.use_ema=true")
    with pytest.raises(SystemExit, match="requires ckpt_path"):
        _predict(root, "o4", "ckpt.use_ema=true")


def test_train_resumes_from_its_checkpoints(trained):
    root, out, _ = trained
    jl = root / "corpus.jsonl"
    summary = main(["train", "experiment=SGMSE_debug", f"data.clean_json_path={jl}",
                    f"data.noise_json_path={jl}", "data.reverb_use_FRA=true",
                    "data.min_duration_seconds=0.1", "data.speech_splice_seconds=1",
                    "data.num_workers=0", "train.max_epochs=2", "train.ema_decay=0.5",
                    f"out_dir={out}", f"ckpt_path={out}/checkpoints", "device=cpu"])
    assert [h["epoch"] for h in summary["history"]] == [1]
    assert summary["optimizer_steps"] == 2
    assert CheckpointManager(os.path.join(out, "checkpoints")).restore(1)["step"] == 4


def test_lightning_checkpoints_predict_as_their_state_dicts(tmp_path):
    """ckpt_path repair: a Lightning checkpoint holds the backbone under
    Score.score_net. (sgmse) or G.net. (lsgan; with the time embedding's
    all_modules.0.W that a non-conditional net does not hold); it predicts
    exactly as the bare state_dict does, and ckpt.lenient=true loads it too."""
    import use_tpu_torch.models  # noqa: F401
    from use_tpu_torch.models import BackboneRegistry

    write_wav(str(tmp_path / "in" / "a.wav"),
              (0.1 * np.random.default_rng(1).standard_normal(5000)).astype(np.float32), SR)
    for exp, prefix, net in (
            ("SGMSE_debug", "Score.score_net.",
             BackboneRegistry.get_by_name("ncsnpp6M")(input_channels=4, seed=3)),
            ("LSGAN_debug", "G.net.",
             BackboneRegistry.get_by_name("ncsnpp6M")(discriminative=True, seed=3))):
        sd = net.state_dict()
        bare, light = str(tmp_path / f"{exp}.pt"), str(tmp_path / f"{exp}.ckpt")
        torch.save(sd, bare)
        wrapped = {prefix + k: v for k, v in sd.items()}
        wrapped["other.module.weight"] = torch.zeros(1)
        if prefix == "G.net.":
            wrapped[prefix + "all_modules.0.W"] = torch.zeros(16)
        torch.save({"state_dict": wrapped, "epoch": 3}, light)
        outs = []
        for path, extra in ((bare, ()), (light, ()), (light, ("ckpt.lenient=true",))):
            tgt = tmp_path / f"out_{exp}_{len(outs)}"
            main(["predict", f"experiment={exp}", "device=cpu", "infer.N=1",
                  f"predict.data_folder={tmp_path / 'in'}", f"predict.target_folder={tgt}",
                  f"ckpt_path={path}", *extra])
            outs.append(read_wav(str(tgt / "a.wav"))[0])
        np.testing.assert_array_equal(outs[1], outs[0])
        np.testing.assert_array_equal(outs[2], outs[0])
        torch.save({"state_dict": {"other.module.weight": torch.zeros(1)}}, light)
        with pytest.raises(SystemExit, match=prefix.replace(".", r"\.")):
            main(["predict", f"experiment={exp}", "device=cpu", f"ckpt_path={light}",
                  f"predict.data_folder={tmp_path / 'in'}", f"predict.target_folder={tmp_path / 'x'}"])


def test_ckpt_with_pickled_objects_loads_only_as_a_lightning_ckpt(tmp_path, caplog):
    """Checkpoints load with weights_only=True. A Lightning .ckpt whose
    hyper-parameters pickle other objects is unpickled in full with a
    warning; a .pt holding such objects is refused."""
    import argparse
    import pickle
    from use_tpu_torch.cli.main import _checkpoint_state

    sd = {"Score.score_net.a": torch.arange(3.0)}
    hp = argparse.Namespace(lr=1e-4)
    ckpt, pt = str(tmp_path / "m.ckpt"), str(tmp_path / "m.pt")
    torch.save({"state_dict": sd, "hyper_parameters": hp}, ckpt)
    torch.save({"state_dict": sd, "hyper_parameters": hp}, pt)
    with caplog.at_level("WARNING", logger="use_tpu_torch"):
        got = _checkpoint_state(ckpt, "sgmse", False)
    assert list(got) == ["a"] and torch.equal(got["a"], sd["Score.score_net.a"])
    assert "unpickling it in full" in caplog.text
    with pytest.raises(pickle.UnpicklingError):
        _checkpoint_state(pt, "sgmse", False)
    caplog.clear()
    torch.save({"state_dict": sd}, ckpt)
    with caplog.at_level("WARNING", logger="use_tpu_torch"):
        assert list(_checkpoint_state(ckpt, "sgmse", False)) == ["a"]
    assert "unpickling" not in caplog.text


@pytest.mark.parametrize("data,train", [
    ({"batch_size": "auto", "micro_batch_per_device": 2}, {"accumulate_grad_batches": "auto",
                                                            "effective_batch": 8}),
    ({"batch_size": 2}, {"accumulate_grad_batches": 4}),
    ({"batch_size": 3}, {"accumulate_grad_batches": "auto"}),
])
def test_resolve_auto_batch_matches_jax_on_one_device(data, train):
    got = {"data": dict(data), "train": dict(train)}
    want = {"data": dict(data), "train": dict(train)}
    resolve_auto_batch(got, 1)
    jresolve(want, 1)
    assert got == want
