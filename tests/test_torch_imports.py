"""The port stands alone: importing every module of ``repro_torch``
loads neither ``jax`` nor anything of the reference package nor
``ml_dtypes``, and an entry point given no device on a machine without a
GPU raises instead of running on the CPU."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    # no GPU visible, whatever the machine has
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
        "             or m.startswith(('repro.', 'ml_dtypes')))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 20                     # the whole package walked
    assert {"repro_torch.serving.page_layouts",
            "repro_torch.kernels.kq_decode.ops",
            "repro_torch.kernels.kq_decode.paged",
            "repro_torch.kernels.flash",
            "repro_torch.kernels.flash.flash",
            "repro_torch.configs.h2o_danube_1_8b",
            "repro_torch.configs.mamba2_2_7b",
            "repro_torch.models.ssm",
            "repro_torch.kernels.ssd",
            "repro_torch.kernels.ssd.ref",
            "repro_torch.kernels.ssd.ssd",
            "repro_torch.configs.smollm_360m",
            "repro_torch.configs.deepseek_67b",
            "repro_torch.core.theory",
            "repro_torch.optim.adamw",
            "repro_torch.optim.adafactor",
            "repro_torch.optim.schedule",
            "repro_torch.train.losses",
            "repro_torch.train.steps",
            "repro_torch.train.trainer",
            "repro_torch.checkpoint.manager",
            "repro_torch.launch.train",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.configs.musicgen_large",
            "repro_torch.configs.phi_3_vision_4_2b",
            "repro_torch.data.synthetic",
            "repro_torch.tree",
            "repro_torch.bridge",
            "repro_torch.examples",
            "repro_torch.examples.long_context_decode",
            "repro_torch.kernels.booking",
            "repro_torch.launch.dryrun",
            "repro_torch.roofline.analysis",
            "repro_torch.roofline.flop_count"} <= set(names)


def test_entry_points_without_device_raise_without_gpu():
    code = (
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.config import ServeConfig\n"
        "from repro_torch.models import LM\n"
        "from repro_torch.serving import ServingEngine\n"
        "from repro_torch.config import TrainConfig\n"
        "from repro_torch.train import Trainer\n"
        "cfg = get_config('tinyllama-1.1b').reduced()\n"
        "for make in (lambda: LM(cfg),\n"
        "             lambda: ServingEngine(cfg, {}, ServeConfig()),\n"
        "             lambda: Trainer(cfg, TrainConfig())):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('ran without a device')\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_without_device_fails_without_gpu():
    res = _run("from repro_torch.launch.serve import main; main()",
               "--arch", "tinyllama-1.1b", "--reduced")
    assert res.returncode != 0
    assert "CUDA" in res.stderr


def test_train_cli_without_device_fails_without_gpu():
    res = _run("from repro_torch.launch.train import main; main()",
               "--arch", "smollm-360m", "--reduced", "--steps", "1")
    assert res.returncode != 0
    assert "CUDA" in res.stderr


def test_train_cli_on_cpu():
    res = _run("from repro_torch.launch.train import main; main()",
               "--arch", "smollm-360m", "--reduced", "--steps", "3",
               "--seq-len", "16", "--batch", "2", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("device cpu: steps=3 loss")
