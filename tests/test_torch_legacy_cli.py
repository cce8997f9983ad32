"""The CLI's refusal of the library backbones and chip_smoke's launch
constants of the legacy regeneration, on the CPU.

GaGNet and ConvTasNet are registry modules that no task wrapper can build
(use_tpu's ScoreModel and NCSNPPWrapper fail on both): the CLI refuses
model.backbone=gagnet|convtasnet (task=sgmse) and
model.generator.backbone=... (task=lsgan) where it builds a model, first
(_build_model, which predict, train and eval call), driven here by predict.
"""
import numpy as np
import pytest
import torch

import use_tpu_torch.models  # noqa: F401 (registries)
from use_tpu_torch.cli.main import main
from use_tpu_torch.models.gan.generator import NCSNPPWrapper as TGenerator
from use_tpu_torch.models.sgmse import legacy as tlegacy
from use_tpu_torch.models.sgmse.score_model import ScoreModel as TScoreModel


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["predict", "experiment=SGMSE_debug", "model.backbone=gagnet"],
    ["predict", "experiment=SGMSE_debug", "model.backbone=convtasnet"],
    ["predict", "experiment=LSGAN_debug", "model.generator.backbone=gagnet"],
    ["predict", "experiment=LSGAN_debug", "model.generator.backbone=convtasnet"],
], ids=["sgmse-gagnet", "sgmse-convtasnet", "lsgan-gagnet", "lsgan-convtasnet"])
def test_cli_refuses_library_backbones_before_building(argv, tmp_path, monkeypatch):
    """GaGNet and ConvTasNet are registry modules that no task wrapper can
    build (use_tpu's fail too): the CLI says so before it builds a model."""
    from use_tpu_torch.models.registry import BackboneRegistry

    def no_build(name):
        raise AssertionError(f"a backbone was built: {name}")

    monkeypatch.setattr(BackboneRegistry, "get_by_name", no_build)
    with pytest.raises(SystemExit, match="cannot build"):
        main([*argv, "device=cpu", f"predict.data_folder={tmp_path}",
              f"predict.target_folder={tmp_path / 'o'}"])


def test_regeneration_launch_constants_of_chip_smoke():
    """chip_smoke's phase 30 (legacy_regen): the regeneration's launches are
    one generator forward (PER_GENERATOR_FORWARD, the shipped `ncsnpp`) and
    N score forwards (PER_FORWARD['float32'], ncsnpplarge with 6 input
    channels), counted here at N = 1 on small clips (the counts follow the
    structure, not the size: 32 x 64 and 64 x 64 spectra reach the nets'
    lowest levels)."""
    import chip_smoke
    from use_tpu_torch.ops import fused_skip, gn_stats

    counts = dict(channel_sums=0, gn_apply=0, fused_skip_add=0)
    real = (gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd)

    def counting(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    model = tlegacy.StochasticRegenerationModel(
        denoiser=TGenerator(backbone="ncsnpp", n_fft=62, hop_length=16, num_frames=32,
                            device="cpu"),
        score=TScoreModel(backbone="ncsnpplarge", n_fft=126, hop_length=16, num_frames=64,
                          condition="both", sde_input="denoised", device="cpu"))
    y = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((1, 1000))
                          ).astype(np.float32))
    try:
        gn_stats._channel_sums_fwd = counting("channel_sums", real[0])
        gn_stats._gn_apply_fwd = counting("gn_apply", real[1])
        fused_skip._fused_skip_add_fwd = counting("fused_skip_add", real[2])
        model.enhance(y, torch.Generator().manual_seed(0), N=1)
    finally:
        gn_stats._channel_sums_fwd, gn_stats._gn_apply_fwd, fused_skip._fused_skip_add_fwd = real
    gen, score = chip_smoke.PER_GENERATOR_FORWARD, chip_smoke.PER_FORWARD["float32"]
    assert counts == {k: gen[k] + score[k] for k in counts}
    assert chip_smoke.LEGACY_REGEN_LAUNCHES == {
        k: gen[k] + chip_smoke.CHAIN_N * score[k] for k in chip_smoke.KERNELS if k in gen}
