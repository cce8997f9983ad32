"""The experiment trackers of use_tpu_torch's MetricLogger (wandb, comet,
mlflow, neptune, aim) against use_tpu's (use_tpu/utils/logging.py:64-150),
on fake tracker modules put in sys.modules: the same calls reach the same
fakes, and a missing package is skipped with use_tpu's warning."""
import logging
import sys
import types

import pytest
import torch

from use_tpu.utils import logging as jlogging
from use_tpu_torch.utils import logging as tlogging

TRACKERS = ("wandb", "comet_ml", "mlflow", "neptune", "aim")
OPTIONS = dict(wandb_project="p", wandb_kwargs={"name": "run"}, comet_project="c",
               mlflow_uri="file:///m", mlflow_experiment="e", neptune_project="n/p",
               aim_repo="/a")
ROWS = [{"epoch": 0, "loss_Score": 1.5, "note": "x", "val/si_sdr": 3.0},
        {"step": 5, "loss_Score": 1.25, "lr": 1e-4}]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """An object whose every attribute is a callable that records its call
    (name, args, kwargs) and returns another recorder."""

    def __init__(self, calls, name):
        self._calls, self._name = calls, name

    def __getattr__(self, attr):
        def call(*args, **kwargs):
            self._calls.append((f"{self._name}.{attr}", args, kwargs))
            return _Recorder(self._calls, f"{self._name}.{attr}()")
        return call

    def __getitem__(self, key):
        return _Recorder(self._calls, f"{self._name}[{key!r}]")


def _fakes(calls):
    mods = {}
    for name in TRACKERS:
        mod = types.ModuleType(name)
        rec = _Recorder(calls, name)
        for attr in ("init", "Experiment", "set_tracking_uri", "set_experiment", "start_run",
                     "log_metrics", "end_run", "init_run", "Run"):
            setattr(mod, attr, getattr(rec, attr))
        mods[name] = mod
    return mods


def _drive(logging_module, tmp_path, monkeypatch, mods):
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    logger = logging_module.MetricLogger(csv_path=str(tmp_path / "m.csv"), **OPTIONS)
    for row in ROWS:
        logger.log(dict(row))
    logger.close()


def test_trackers_receive_what_jax_sends(tmp_path, monkeypatch):
    want, got = [], []
    _drive(jlogging, tmp_path / "j", monkeypatch, _fakes(want))
    _drive(tlogging, tmp_path / "t", monkeypatch, _fakes(got))
    assert got == want
    assert {c[0].split(".")[0] for c in got} == set(TRACKERS)


def test_missing_trackers_are_skipped_with_jax_warning(tmp_path, monkeypatch, caplog):
    """sys.modules[name] = None: the import raises, each logger warns once
    a tracker and logs on to the CSV."""
    texts = {}
    for label, module in (("jax", jlogging), ("port", tlogging)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            _drive(module, tmp_path / label, monkeypatch, {n: None for n in TRACKERS})
        texts[label] = sorted(r.getMessage() for r in caplog.records
                              if r.levelno == logging.WARNING)
        assert (tmp_path / label / "m.csv").exists()
    assert texts["port"] == texts["jax"] == sorted(f"{n} unavailable; skipping"
                                                   for n in TRACKERS)


def test_trackers_start_on_rank_zero_only(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tlogging, "_dist_rank", lambda: 1)
    _drive(tlogging, tmp_path, monkeypatch, _fakes(calls))
    assert calls == []
