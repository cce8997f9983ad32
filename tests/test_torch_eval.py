"""The rich metric harness and `eval` of use_tpu_torch, on the CPU.

``evaluate_pair`` and the native ESTOI against use_tpu's on the same
arrays (both numpy in float64 from the same float32 inputs: within 1e-9
relative); ``evaluate_model`` against use_tpu's with one deterministic
enhancer; `eval experiment=SGMSE_debug|LSGAN_debug device=cpu` (test-split
losses, rich metrics; a generator-only checkpoint scores against a fresh
D, with a warning); and ``fit_sgmse(rich_eval_every=1)``.
"""
import json
import logging

import jax
import numpy as np
import pytest
import torch

from use_tpu.engine.evaluate import evaluate_model as jevaluate_model
from use_tpu.utils import metrics as jmetrics
from use_tpu.utils.intelligibility import estoi_np as jestoi_np
from use_tpu_torch.cli.main import main
from use_tpu_torch.data.audio_io import write_wav
from use_tpu_torch.data.synth_speech import synth_pair
from use_tpu_torch.engine.checkpoint import save_params
from use_tpu_torch.engine.evaluate import evaluate_model
from use_tpu_torch.engine.loop import fit_sgmse
from use_tpu_torch.models.gan.generator import NCSNPPWrapper
from use_tpu_torch.models.sgmse.score_model import ScoreModel
from use_tpu_torch.utils import metrics as tmetrics
from use_tpu_torch.utils.intelligibility import estoi_np
from use_tpu_torch.utils.logging import MetricLogger

SR = 24000
RICH = {"si_sdr", "si_sir", "si_sar", "lsd", "estoi"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _triple(seed, length):
    clean, noisy = synth_pair(length, seed, snr_db=5.0, sr=SR)
    enhanced = (0.7 * clean + 0.3 * noisy).astype(np.float32)
    return clean.astype(np.float32), enhanced, noisy.astype(np.float32)


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9 * max(abs(v), 1.0), k


@pytest.mark.parametrize("length", [SR, 3001])  # 1 s; 0.125 s, too short for ESTOI
def test_evaluate_pair_matches_jax(length):
    clean, enhanced, noisy = _triple(3, length)
    got = tmetrics.evaluate_pair(clean, enhanced, noisy, sr=SR)
    want = jmetrics.evaluate_pair(clean, enhanced, noisy, sr=SR)
    _same(got, want)
    assert set(got) == (RICH if length == SR else RICH - {"estoi"})  # no pesq package here


@pytest.mark.parametrize("sr", [10000, SR])
def test_estoi_np_and_the_other_metrics_match_jax(sr):
    clean, enhanced, noisy = _triple(4, sr)
    assert abs(estoi_np(clean, enhanced, sr) - jestoi_np(clean, enhanced, sr)) <= 1e-9
    assert abs(estoi_np(clean, clean, sr) - 1.0) <= 1e-6
    n = noisy - clean
    for got, want in zip(tmetrics.energy_ratios(enhanced, clean, n),
                         jmetrics.energy_ratios(enhanced, clean, n)):
        assert abs(got - want) <= 1e-9 * abs(want)
    assert tmetrics.snr_db(clean, n) == pytest.approx(jmetrics.snr_db(clean, n), rel=1e-12)
    data = np.array([1.0, np.nan, 3.0])
    assert tmetrics.mean_std(data) == jmetrics.mean_std(data)
    with pytest.raises(ImportError, match="pesq"):
        tmetrics.pesq_wb(clean, enhanced)


def test_evaluate_model_matches_jax():
    """Means over the utterances that have each metric (the short one has
    no ESTOI), one figure and one set of audio, as use_tpu's."""
    pairs = [dict(zip(("clean", "perturbed"), _triple(5 + i, n)[::2]))
             for i, n in enumerate((SR, 3001))]

    def enhance(noisy, _):
        return (0.5 * noisy).astype(np.float32)

    got = evaluate_model(enhance, pairs, torch.Generator().manual_seed(0), num_figures=1)
    want = jevaluate_model(enhance, pairs, jax.random.PRNGKey(0), num_figures=1)
    _same(got["metrics"], want["metrics"])
    assert len(got["per_utt"]) == 2 and "estoi" not in got["per_utt"][1]
    assert len(got["figures"]) == len(want["figures"]) == 1
    assert [sorted(a) for a in got["audio"]] == [["clean", "enhanced", "noisy"]]


def test_evaluate_model_without_matplotlib_draws_no_figures(monkeypatch, caplog):
    """Where matplotlib does not import (the card's machine may lack it):
    no figures, one warning for the call, the same metrics and audio."""
    import sys

    pairs = [dict(zip(("clean", "perturbed"), _triple(7 + i, SR)[::2])) for i in range(2)]
    with_figs = evaluate_model(lambda n, g: n, pairs, num_figures=2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING, logger="use_tpu_torch"):
        out = evaluate_model(lambda n, g: n, pairs, num_figures=2)
    assert out["figures"] == [] and caplog.text.count("draws no figures") == 1
    assert out["metrics"] == with_figs["metrics"] and len(out["audio"]) == 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    jl = root / "corpus.jsonl"
    with open(jl, "w") as f:
        for i in range(2):
            clean, _ = synth_pair(SR, i, snr_db=5.0, sr=SR)
            path = str(root / f"u{i}.wav")
            write_wav(path, clean.astype(np.float32), SR)
            f.write(json.dumps({"file_path": path, "duration": 1.0, "sample_rate": SR}) + "\n")
    data = [f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
            "data.reverb_use_FRA=true", "data.min_duration_seconds=0.1",
            "data.speech_splice_seconds=1", "data.num_workers=0"]
    return root, data


def test_cli_eval_sgmse(corpus):
    root, data = corpus
    out = main(["eval", "experiment=SGMSE_debug", *data, "infer.N=2", "eval.max_files=2",
                f"out_dir={root / 'ev_sgmse'}", "device=cpu"])
    assert set(out["test"]) == {"test/loss_Score"} and np.isfinite(out["test"]["test/loss_Score"])
    assert set(out["rich"]) == RICH and all(np.isfinite(v) for v in out["rich"].values())
    assert out["files"] == 2 and out["figures"] == 2
    rows = (root / "ev_sgmse" / "metrics.csv").read_text()
    assert "test/loss_Score" in rows and "test/si_sdr" in rows


def test_cli_eval_lsgan_of_a_generator_only_checkpoint_warns(corpus, caplog):
    """A bare generator state_dict: the losses are scored against a freshly
    initialized D, with the warning; eval.rich=false skips the harness."""
    root, data = corpus
    gen = NCSNPPWrapper(backbone="ncsnpp6M", n_fft=254, hop_length=64, num_frames=32,
                        device="cpu", seed=9)
    save_params(str(root / "g.pt"), gen.net.state_dict())
    with caplog.at_level(logging.WARNING, logger="use_tpu_torch"):
        out = main(["eval", "experiment=LSGAN_debug", *data, f"ckpt_path={root / 'g.pt'}",
                    "eval.max_files=1", f"out_dir={root / 'ev_gan'}", "device=cpu"])
    assert "freshly initialized D" in caplog.text
    assert {"test/loss_G", "test/loss_G_adv_gen", "test/loss_G_mel_log"} <= set(out["test"])
    assert all(np.isfinite(v) for v in out["test"].values()) and len(out["test"]) == 9
    assert set(out["rich"]) == RICH and out["files"] == 1
    skipped = main(["eval", "experiment=LSGAN_debug", *data, "eval.rich=false",
                    f"out_dir={root / 'ev_gan2'}", "device=cpu"])
    assert skipped["rich"] is None and len(skipped["test"]) == 9


class _Rows(MetricLogger):
    def __init__(self):
        super().__init__()
        self.rows, self.figures, self.audio = [], [], []

    def log(self, row):
        self.rows.append(dict(row))

    def log_figure(self, tag, fig, step=0):
        self.figures.append(tag)
        super().log_figure(tag, fig, step)

    def log_audio(self, tag, wav, sr, step=0):
        self.audio.append(tag)


class _Pairs:
    def __init__(self, length=992):
        pairs = [synth_pair(length, s, snr_db=5.0, sr=SR) for s in range(4)]
        self.clean = np.stack([p[0] for p in pairs])
        self.noisy = np.stack([p[1] for p in pairs])

    def train_dataloader(self):
        yield {"clean": self.clean[:2], "perturbed": self.noisy[:2]}

    def val_dataloader(self):
        yield {"clean": self.clean[2:], "perturbed": self.noisy[2:]}


def test_fit_sgmse_rich_eval_every_epoch():
    """rich_eval_every=1: each epoch logs val/<metric> means of the first
    rich_eval_files validation utterances (enhanced at N=rich_eval_N), with
    their figures and audio."""
    model = ScoreModel(backbone="ncsnpp", condition="noisy", sde_input="noisy", n_fft=126,
                       hop_length=32, num_frames=32, device="cpu",
                       backbone_kwargs=dict(nf=16, ch_mult=(1, 1), num_res_blocks=1))
    logger = _Rows()
    res = fit_sgmse(model, _Pairs(), accumulate_grad_batches=1, max_epochs=2, logger=logger,
                    rich_eval_every=1, rich_eval_files=2, rich_eval_N=2)
    rich = [r for r in logger.rows if "val/si_sdr" in r]
    assert [r["epoch"] for r in rich] == [0, 1] and len(res.history) == 2
    for r in rich:
        assert {f"val/{k}" for k in RICH - {"estoi"}} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    assert logger.figures == ["val/example_0", "val/example_1"] * 2
    assert len(logger.audio) == 12  # 2 epochs x 2 utterances x noisy / enhanced / clean
