"""use_tpu_torch stands alone: importing it (every submodule) loads neither
JAX (nor flax, optax, orbax) nor any use_tpu module, no source of the port
or chip_smoke.py imports them, and its entry points default to CUDA and
raise without a card."""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "use_tpu")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(%s)(\.|\s|$)" % "|".join(FORBIDDEN_ROOTS), re.M)


def test_import_loads_no_jax_or_use_tpu():
    # a subprocess: tests/conftest.py has already imported jax in this one
    code = (
        "import importlib, pkgutil, sys\n"
        "import use_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(use_tpu_torch.__path__, 'use_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN_ROOTS})\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('use_tpu_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40  # every submodule was imported


def test_data_parallel_and_tool_modules_import_alone():
    """The modules of data-parallel training and the tools (parallel/mesh,
    cli/sweep, utils/utils and the ranked logger) are part of the package
    walk above, and each imports without JAX or use_tpu on its own."""
    names = ("use_tpu_torch.parallel.mesh", "use_tpu_torch.cli.sweep",
             "use_tpu_torch.utils.utils", "use_tpu_torch.utils.logging")
    code = (
        "import importlib, sys\n"
        f"for n in {names}:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN_ROOTS})\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax_or_use_tpu():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "use_tpu_torch")):
        paths += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            hits = FORBIDDEN.findall(f.read())
        assert not hits, (path, hits)


def test_entry_points_default_to_cuda():
    from use_tpu_torch.cli.main import main
    from use_tpu_torch.models.sgmse.score_model import ScoreModel
    from use_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device=cpu"):
        resolve_device()
    with pytest.raises(RuntimeError):
        ScoreModel()
    with pytest.raises(RuntimeError):
        main(["predict", "experiment=SGMSE_debug", "predict.data_folder=in",
              "predict.target_folder=out"])
    assert resolve_device("cpu").type == "cpu"


def test_gan_and_chain_entry_points_default_to_cuda():
    """The LSGAN generator and task, and predict for task=lsgan and both
    chains, run on CUDA unless asked for the CPU, and raise without a card."""
    from use_tpu_torch.cli.main import main
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper
    from use_tpu_torch.models.gan.lsgan import LSGAN

    if torch.cuda.is_available():
        assert NCSNPPWrapper(backbone="ncsnpp6M").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device=cpu"):
        NCSNPPWrapper(backbone="ncsnpp6M")
    with pytest.raises(RuntimeError):
        LSGAN()
    folders = ["predict.data_folder=in", "predict.target_folder=out"]
    for argv in (["experiment=LSGAN_debug"],
                 ["experiment=SGMSE_debug", "predict.chain=sgmse+gan",
                  "predict.second_experiment=LSGAN_debug"],
                 ["experiment=LSGAN_debug", "predict.chain=gan+sgmse",
                  "predict.second_experiment=SGMSE_debug"]):
        with pytest.raises(RuntimeError, match="device=cpu"):
            main(["predict", *argv, *folders])
    assert NCSNPPWrapper(backbone="ncsnpp6M", device="cpu").device.type == "cpu"


def test_train_entry_points_default_to_cuda():
    """train, its loop's model and the data pipeline's device: CUDA unless
    asked for the CPU, raising without a card."""
    from use_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device=cpu"):
        main(["train", "experiment=SGMSE_debug", "data.clean_json_path=x.jsonl",
              "data.noise_json_path=x.jsonl"])


def test_legacy_and_backbone_entry_points_default_to_cuda():
    """The legacy family (LegacyScoreModel, DiscriminativeModel,
    StochasticRegenerationModel) runs on CUDA unless asked for the CPU,
    raising without a card; the backbones GaGNet and ConvTasNet are
    modules, built on the CPU and moved as any torch module."""
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper
    from use_tpu_torch.models.sgmse import legacy
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    tiny = dict(backbone="ncsnpp", n_fft=126, hop_length=32, num_frames=32,
                backbone_kwargs=dict(nf=8, ch_mult=(1, 1), num_res_blocks=1))
    if torch.cuda.is_available():
        assert legacy.DiscriminativeModel(**tiny).device.type == "cuda"
        return
    for build in (lambda: legacy.LegacyScoreModel(**tiny),
                  lambda: legacy.DiscriminativeModel(**tiny),
                  lambda: legacy.StochasticRegenerationModel()):
        with pytest.raises(RuntimeError, match="device=cpu"):
            build()
    assert legacy.DiscriminativeModel(**tiny, device="cpu").device.type == "cpu"
    regen = legacy.StochasticRegenerationModel(
        denoiser=NCSNPPWrapper(**tiny, device="cpu"), score=ScoreModel(**tiny, device="cpu"))
    assert regen.score.device.type == "cpu"
