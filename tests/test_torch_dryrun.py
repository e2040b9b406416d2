"""The port's dry-run (``repro_torch.launch.dryrun``): every cell that
``shape_applicable`` admits, at depth 1 (``dryrun_lib.with_depth``) and full
width, runs OK on the 16x16 and 2x16x16 production meshes, each group of
architectures in a process of its own (the fake world of 256 / 512 ranks
owns its process's default group); and on reduced qwen3 the port's
per-device argument bytes equal the JAX package's ``lower_cell`` on the same
8-device (2, 4) mesh, exactly (the reference in a process with 8 host
devices)."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro_torch.configs.base import ALL_SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
# the architectures one process lowers, balanced by their cells' seconds
GROUPS = (("dbrx-132b", "qwen3-1.7b"), ("mixtral-8x7b", "whisper-small"),
          ("phi-3-vision-4.2b",), ("llama3-405b", "yi-34b"),
          ("qwen3-0.6b", "mamba2-2.7b", "recurrentgemma-9b"))


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return env


def _run_group(archs, out):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--depth",
           "1", "--mesh", "both", "--out", out]
    for a in archs:
        cmd += ["--arch", a]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          timeout=900)
    with open(out) as f:
        return proc.returncode, json.load(f), proc.stdout[-3000:]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        runs = list(pool.map(
            lambda ig: _run_group(ig[1], str(d / f"g{ig[0]}.json")),
            enumerate(GROUPS)))
    out = {}
    for rc, results, tail in runs:
        for r in results:
            out[(r["arch"], r["shape"], r["mesh"])] = (r, tail)
    return out


def test_groups_cover_every_arch():
    assert sorted(a for g in GROUPS for a in g) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_applicable_cell_runs_on_both_meshes(cells, arch):
    cfg = get_config(arch)
    want = [s.name for s in ALL_SHAPES if shape_applicable(cfg, s)[0]]
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        for shape in want:
            r, tail = cells[(arch, shape, mesh)]
            assert r["ok"], (arch, shape, mesh, r["error"], tail)
            assert r["n_devices"] == n and r["compile_s"] == 0.0
            assert r["mem"]["argument_bytes"] > 0
            assert r["flops_per_dev"] > 0
            assert set(r["coll_detail"]["bytes_by_kind"]) == {
                "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute"}
    skipped = [s.name for s in ALL_SHAPES if s.name not in want]
    assert not any((arch, s, m) in cells for s in skipped
                   for m in ("16x16", "2x16x16"))


SMALL = {"train": ("small_train", 64, 8, "train"),
         "decode": ("small_decode", 64, 8, "decode")}

PORT = """
import json
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun_lib import lower_cell
from repro_torch.launch.mesh import make_mesh
dryrun.init_fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
cfg = get_config("qwen3-0.6b").reduced()
out = {}
for kind, shape in %r.items():
    r = lower_cell(cfg, InputShape(*shape), mesh)
    assert r.ok, r.error
    out[kind] = r.mem["argument_bytes"]
print(json.dumps(out))
"""

REF = """
import json
from repro.configs.base import InputShape
from repro.configs.registry import get_config
from repro.launch.dryrun_lib import lower_cell
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
cfg = get_config("qwen3-0.6b").reduced()
out = {}
for kind, shape in %r.items():
    r = lower_cell(cfg, InputShape(*shape), mesh)
    assert r.ok, r.error
    out[kind] = r.mem["argument_bytes"]
print(json.dumps(out))
"""


def _last_json(code, env):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reduced_qwen3_argument_bytes_equal_the_reference():
    """Parameters (bf16), the AdamW state (m and v f32 on the ZeRO axis,
    step int32), the cache and the batch (int32 token ids), summed over one
    device's shards: the same bytes as XLA's memory analysis of the
    reference's compiled cell."""
    port = _last_json(PORT % (SMALL,), _env())
    ref = _last_json(REF % (SMALL,), _env(
        XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert port == ref and set(port) == {"train", "decode"}
