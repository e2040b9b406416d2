"""The port stands alone: it imports neither ``jax`` nor anything of the JAX
package ``repro`` (nor ``ml_dtypes``, which the card's machine lacks), it
runs on the card unless asked for the CPU, and its kernel modules import on
a machine with no CUDA compiler."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import device as devmod  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(SRC)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods
    for name in ("kernels.flash_attention", "kernels.decode_attention",
                 "kernels.ssd_scan", "kernels.rglru_scan", "models.mamba2",
                 "models.rglru", "core.control_plane", "core.scheduler",
                 "kernels.policy_score", "chains.executor", "chains.planner",
                 "inspector.scenario", "kernels.warm_forecast",
                 "autoscale.forecast", "autoscale.policies",
                 "autoscale.controller", "obs.recorder", "obs.analysis",
                 "obs.export", "obs.telemetry", "obs.alerts",
                 "obs.provenance", "obs.whatif", "launch.bench_autoscale",
                 "launch.explain", "models.moe", "models.whisper",
                 "train.optimizer", "train.train_step", "data.pipeline",
                 "checkpoint.checkpointer", "launch.train",
                 "launch.quickstart", "models.model_api", "models.convert",
                 "sharding", "launch.mesh", "launch.dryrun",
                 "launch.dryrun_lib", "launch.train_multipod",
                 "launch.mesh_parity"):
        assert f"repro_torch.{name}" in mods
    # importing the mesh and dry-run modules starts no process group
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'repro'"
            " or m.startswith('repro.') or m == 'ml_dtypes')\n"
            "import torch.distributed as dist\n"
            "if dist.is_initialized():\n"
            "    bad.append('a process group')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert devmod.resolve(None).type == "cuda"
    else:
        with pytest.raises(devmod.NoCudaDevice, match="CUDA card"):
            devmod.resolve(None)
        with pytest.raises(devmod.NoCudaDevice):
            devmod.generator(0)
    assert devmod.resolve("cpu") == torch.device("cpu")


def test_serve_launcher_names_the_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    proc = _run("import sys\n"
                "from repro_torch.launch import serve\n"
                "sys.exit(serve.main(['--requests', '1']))\n")
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-small"])
def test_serve_launcher_refuses_what_the_engine_cannot_feed(arch, capsys):
    """The engine feeds token ids only (as the JAX engine does): the VLM
    and encoder-decoder archs exit 2 with a message, card or no card."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "token ids only" in err and "model_api" in err


def test_batch_scheduling_launcher_names_the_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    proc = _run("import sys\n"
                "from repro_torch.launch import batch_scheduling\n"
                "sys.exit(batch_scheduling.main(['--arrivals', '10']))\n")
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr


@pytest.mark.parametrize("launcher,argv", [
    ("inspector_scenario", "['smoke/tiny']"), ("chain_execution", "[]"),
    ("bench_autoscale", "['--smoke']"), ("explain", "['prov/smoke-tiny']")])
def test_inspector_launchers_name_the_missing_card(launcher, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    proc = _run("import sys\n"
                f"from repro_torch.launch import {launcher}\n"
                f"sys.exit({launcher}.main({argv}))\n")
    assert proc.returncode == 2
    assert "no CUDA card" in proc.stderr
    assert not proc.stdout


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ)
    env["PATH"] = str(tmp_path)             # no nvcc anywhere on it
    env.pop("CUDA_HOME", None)
    proc = _run("from repro_torch.kernels import (flash_attention, ops,\n"
                "    decode_attention, rglru_scan, ssd_scan, policy_score,\n"
                "    _build)\n"
                "import torch\n"
                "q = torch.zeros(1, 16, 4, 32)\n"
                "ops.flash_attention(q, q[:, :, :2], q[:, :, :2])\n"
                "x = torch.zeros(1, 16, 2, 8)\n"
                "bc = torch.zeros(1, 16, 1, 8)\n"
                "ops.ssd_scan(x, x[..., 0], torch.zeros(2), bc, bc, "
                "chunk=16)\n"
                "ops.rglru_scan(q[..., 0], q[..., 0])\n"
                "ops.decode_attention(q[:, 0], q[:, :, :2], q[:, :, :2],\n"
                "    torch.full((1,), 5, dtype=torch.int32))\n"
                "assert flash_attention.flash_attention_cuda.launches == 0\n"
                "assert decode_attention.decode_attention_cuda.launches"
                " == 0\n"
                "assert ssd_scan.ssd_scan_cuda.launches == 0\n"
                "c = torch.zeros(2, 5)\n"
                "a = torch.ones(2, 5, dtype=torch.bool)\n"
                "n = torch.zeros(2, 5, dtype=torch.int32)\n"
                "u = torch.ones(5, dtype=torch.bool)\n"
                "policy_score.fused_composite_decide_pallas(c, n, c, c, n,"
                " c, c[0], c[0], a, u, c[:, 0], 0.1)\n"
                "policy_score.composite_decide_pallas(c, c, c, c, a, u, "
                "c[:, 0], 0.1)\n"
                "assert rglru_scan.rglru_scan_cuda.launches == 0\n"
                "assert policy_score.fused_composite_decide_cuda.launches"
                " == 0\n"
                "assert policy_score.composite_decide_cuda.launches == 0\n"
                "assert not _build._LIBS\n", env)
    assert proc.returncode == 0, proc.stderr
