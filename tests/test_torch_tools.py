"""The port's tools against use_tpu's, on the CPU: the sweep's samplers
(copied as they are: the same proposals from the same history and
random.Random state) and a sweep's trials and best.json, the task
utilities, WER, the ranked logger, and the asynchronous checkpoint."""
import glob
import json
import logging
import os
import random

import numpy as np
import pytest
import torch

from use_tpu.cli import sweep as jsweep
from use_tpu.utils import metrics as jmetrics, utils as jutils
from use_tpu_torch.cli import sweep as tsweep
from use_tpu_torch.engine.checkpoint import CheckpointManager
from use_tpu_torch.utils import logging as tlogging, metrics as tmetrics, utils as tutils

SPACES = ["uniform(0.01,0.1)", "loguniform(1e-5,1e-3)", "choice(1,2,4,\"x\")"]


@pytest.mark.parametrize("spec", SPACES)
@pytest.mark.parametrize("n_history", [0, 3, 9])
def test_samplers_match_jax(spec, n_history):
    """_parse_space, _sample and tpe_propose (random warmup below 4 trials,
    the Parzen ratio above) give use_tpu's values and leave the random
    state where use_tpu's leaves it."""
    assert tsweep._parse_space(spec) == jsweep._parse_space(spec)
    hist_rng = random.Random(5)
    history = [(hist_rng.random(), jsweep._sample(spec, hist_rng)) for _ in range(n_history)]
    a, b = random.Random(1), random.Random(1)
    for _ in range(3):
        assert tsweep.tpe_propose(spec, history, a) == jsweep.tpe_propose(spec, history, b)
        assert tsweep._sample(spec, a) == jsweep._sample(spec, b)
    assert a.getstate() == b.getstate()
    for x in (-1.0, 0.2, 3.0):
        assert tsweep._kde_logpdf(x, [0.1, 0.5], 0.3) == jsweep._kde_logpdf(x, [0.1, 0.5], 0.3)


def _fake_train(log):
    """A cmd_train that records its call and writes what a trial leaves: the
    optimized metric (a bowl in log lr), or only the CSV on every third."""

    def cmd_train(experiment, overrides, extras):
        lr = float(dict(o.split("=", 1) for o in overrides)["train.lr"])
        value = (np.log10(lr) + 4.0) ** 2
        out = extras["out_dir"]
        os.makedirs(out, exist_ok=True)
        log.append((experiment, list(overrides), dict(extras)))
        with open(os.path.join(out, "metrics.csv"), "w") as f:
            f.write(f"epoch,val/loss_Score\n0,{value + 1.0}\n")
        if len(log) % 3:
            with open(os.path.join(out, "optimized_metric.json"), "w") as f:
                json.dump({"metric": "val/loss_Score", "value": value, "test": {}}, f)

    return cmd_train


@pytest.mark.parametrize("sampler", ["random", "tpe"])
def test_sweep_runs_trials_and_writes_best_as_jax(tmp_path, monkeypatch, sampler):
    """use_tpu's sweep and the port's, each over its own cmd_train
    (monkeypatched, as tests/test_cli.py's smoke): the same trials, the
    CSV fallback, the same best.json; device= goes to the port's trials."""
    import use_tpu.cli.main as jmain
    import use_tpu_torch.cli.main as tmain

    argv = ["experiment=SGMSE_debug", "n_trials=6", f"sampler={sampler}",
            "metric=val/loss_Score", "space.train.lr=loguniform(1e-6,1e-2)", "data.x=1"]
    best = {}
    for name, mod, main, extra in (("jax", jmain, jsweep.main, []),
                                   ("port", tmain, tsweep.main, ["device=cpu"])):
        calls = []
        monkeypatch.setattr(mod, "cmd_train", _fake_train(calls))
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(argv + extra)
        (path,) = glob.glob(str(tmp_path / name / "runs" / "sweep" / "*" / "best.json"))
        with open(path) as f:
            best[name] = json.load(f)
        best[name + "_calls"] = [(e, o) for e, o, _ in calls]
        assert len(calls) == 6
    assert best["port"] == best["jax"]
    assert best["port_calls"] == best["jax_calls"]
    assert calls[0][2]["device"] == "cpu"


def test_task_utilities_match_jax(tmp_path, caplog):
    """extras / print_config_tree (the same lines), enforce_tags,
    get_metric_value, task_wrapper and rtf, as use_tpu's."""
    cfg = {"a": 1, "b": {"c": [1, 2], "d": {"e": "x"}}, "print_config": True}
    with caplog.at_level(logging.INFO):
        tutils.extras(cfg)
    port = [r.getMessage() for r in caplog.records if r.name == "use_tpu_torch"]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jutils.extras(cfg)
    assert port == [r.getMessage() for r in caplog.records if r.name == "use_tpu"]
    for mod in (tutils, jutils):
        c = {}
        mod.enforce_tags(c, save_to=str(tmp_path / f"{mod.__name__}.tags"))
        assert c["tags"] == ["dev"]
    assert (tmp_path / "use_tpu_torch.utils.utils.tags").read_text() == \
        (tmp_path / "use_tpu.utils.utils.tags").read_text()
    m = {"val/loss": 0.5}
    assert tutils.get_metric_value(m, "val/loss") == jutils.get_metric_value(m, "val/loss")
    assert tutils.get_metric_value(m, None) is None
    with pytest.raises(KeyError, match="not found"):
        tutils.get_metric_value(m, "x")
    assert tutils.rtf(1.5, 48000, 24000) == jutils.rtf(1.5, 48000, 24000)
    assert tutils.task_wrapper(lambda x: x + 1)(1) == 2

    @tutils.task_wrapper
    def boom():
        raise ValueError("x")

    with pytest.raises(ValueError):
        boom()


def test_profiler_writes_a_chrome_trace(tmp_path):
    with tutils.profiler(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with tutils.profiler(None):
        pass


def test_wer_matches_jax():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "d"]
    for n, m in ((0, 3), (5, 0), (7, 9), (12, 12)):
        r = list(rng.choice(words, n))
        h = list(rng.choice(words, m))
        assert tmetrics.wer(r, h) == jmetrics.wer(r, h)
    assert tmetrics.wer(["a", "b"], ["a", "b"]) == 0.0


def test_ranked_logger_drops_other_ranks_records(tmp_path, caplog, monkeypatch):
    """Records of rank 1 (read when each is emitted) are dropped, and its
    MetricLogger writes no CSV; rank 0's go through."""
    log = tlogging.ranked_logger()
    assert tlogging.ranked_logger() is log and len(log.filters) == 1
    with caplog.at_level(logging.INFO, logger="use_tpu_torch"):
        monkeypatch.setattr(tlogging, "_dist_rank", lambda: 1)
        log.info("from rank 1")
        tlogging.MetricLogger(csv_path=str(tmp_path / "r1.csv")).log({"epoch": 0, "x": 1.0})
        monkeypatch.setattr(tlogging, "_dist_rank", lambda: 0)
        log.info("from rank 0")
        tlogging.MetricLogger(csv_path=str(tmp_path / "r0.csv")).log({"epoch": 0, "x": 1.0})
    messages = [r.getMessage() for r in caplog.records]
    assert "from rank 0" in messages and "from rank 1" not in messages
    assert not (tmp_path / "r1.csv").exists() and (tmp_path / "r0.csv").exists()
    assert tlogging._dist_rank() == 0 or torch.distributed.is_initialized()


def test_async_checkpoint_is_a_snapshot_and_round_trips(tmp_path):
    """save() with async_save copies the state to host memory and writes it
    on a thread: a change to the state right after the call does not reach
    the file; restore (after wait) gives the synchronous save's tensors bit
    for bit; the next save joins the last; metrics and top-k as before."""
    net = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(net.parameters(), 1e-3)
    net(torch.ones(2, 4)).sum().backward()
    opt.step()
    state = {"model": net.state_dict(), "optimizer": opt.state_dict(), "step": 1}
    sync = CheckpointManager(str(tmp_path / "sync"), monitor="val/loss")
    sync.save(0, state, {"val/loss": 1.0})
    want = {k: v.clone() for k, v in net.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "async"), monitor="val/loss", async_save=True,
                            max_to_keep=1)
    mgr.save(0, state, {"val/loss": 1.0})
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)  # the next step changes the state in place
    mgr.save(1, {"model": net.state_dict(), "step": 2}, {"val/loss": 2.0})
    mgr.wait()
    assert mgr.steps() == [0]  # max_to_keep 1: the worse step 1 went
    got, ref = mgr.restore(0), sync.restore(0)
    for k, v in want.items():
        assert torch.equal(got["model"][k], v) and torch.equal(ref["model"][k], v)
    assert got["optimizer"]["state"][0]["exp_avg"].equal(ref["optimizer"]["state"][0]["exp_avg"])
    assert mgr.metrics(0) == {"val/loss": 1.0} and got["step"] == 1
