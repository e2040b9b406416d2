"""The port's sharding rules against the JAX package's: the spec of every
parameter (``param_fsdp`` where the config sets it), of the ZeRO-1 optimizer
state, of the caches of every decode shape and of the batches of every
shape, for all ten architectures on the 16x16 and 2x16x16 production
meshes (abstract meshes on both sides: no devices), entry for entry; the
per-device bytes those rules give; which slice each device of an 8-device
mesh holds (fresh processes: 8 host devices for JAX, a fake world of 8 ranks
for the port); and the JAX package's own sharding tests, ported."""
import json
import os
import subprocess
import sys

import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import registry as jreg
from repro.configs.base import ALL_SHAPES, shape_applicable
from repro.models import model_api as japi
from repro.models import params as jpm
from repro.train import optimizer as jopt
from repro_torch import sharding as shd
from repro_torch.configs import registry as treg
from repro_torch.models import model_api as tapi
from repro_torch.models import params as tpm
from repro_torch.train import optimizer as topt

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return shd.AbstractMesh(sizes, names), JAbstractMesh(sizes, names)


def _ref(spec):
    """The reference's PartitionSpec as the port's tuple (trailing Nones
    dropped)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _pairs(port_tree, ref_tree, prefix=""):
    if isinstance(port_tree, dict):
        assert sorted(port_tree) == sorted(ref_tree), prefix
        for k in port_tree:
            yield from _pairs(port_tree[k], ref_tree[k], f"{prefix}/{k}")
    else:
        yield prefix, port_tree, _ref(ref_tree)


def _assert_same(port_tree, ref_tree):
    n = 0
    for path, got, want in _pairs(port_tree, ref_tree):
        assert got == want, (path, got, want)
        n += 1
    assert n > 0


ARCHS = treg.ARCH_IDS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh):
    tm, jm = _meshes(mesh)
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    _assert_same(tapi.param_pspecs(tcfg, tm), japi.param_pspecs(jcfg, jm))
    tstate = topt.state_specs(tapi.model_specs(tcfg))
    jstate = jopt.state_specs(japi.model_specs(jcfg))
    for part in ("m", "v", "ef"):
        _assert_same(tpm.pspecs(tstate[part], tm),
                     jpm.pspecs(jstate[part], jm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    tm, jm = _meshes(mesh)
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for shape in ALL_SHAPES:
        if not shape_applicable(jcfg, shape)[0]:
            continue
        if shape.kind == "decode":
            b, s = shape.global_batch, shape.seq_len
            _assert_same(tapi.cache_pspecs(tcfg, tm, b, s),
                         japi.cache_pspecs(jcfg, jm, b, s))
            tb, jb = (tapi.decode_batch_specs(tcfg, shape),
                      japi.decode_batch_specs(jcfg, shape))
        else:
            tb, jb = (tapi.batch_specs(tcfg, shape),
                      japi.batch_specs(jcfg, shape))
        _assert_same(tpm.pspecs(tb, tm), jpm.pspecs(jb, jm))
        assert {k: (s.shape, str(v.dtype).replace("torch.", ""))
                for k, s in tb.items()
                for v in [tapi.input_specs(tcfg, shape)[k]]} == {
            k: (s.shape, str(v.dtype))
            for k, s in jb.items()
            for v in [japi.input_specs(jcfg, shape)[k]]}


def _local_numel(shape, spec, sizes):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        flat = entry if isinstance(entry, tuple) else (
            (entry,) if entry else ())
        div = 1
        for a in flat:
            div *= sizes[a]
        n *= d // div
    return n


def _per_device_gb(spec_tree, shape_tree, sizes, nbytes):
    specs = tpm.tree_leaves(spec_tree)
    shapes = tpm.tree_leaves(shape_tree)
    return sum(_local_numel(s.shape, p, sizes) for p, s in
               zip(specs, shapes)) * nbytes / 1e9


# GB a device holds by the reference's rules (reckoned from its spec_for on
# an AbstractMesh): params in bf16, and m + v in f32 (ZeRO-1)
PER_DEVICE_GB = [
    ("qwen3-0.6b", "16x16", 0.075, 0.019),
    ("mixtral-8x7b", "16x16", 5.840, 1.460),
    ("mixtral-8x7b", "2x16x16", 5.840, 0.730),
    ("llama3-405b", "16x16", 3.171, 12.685),
    ("llama3-405b", "2x16x16", 1.586, 6.342),
    ("dbrx-132b", "16x16", 1.028, 4.113),
    ("mamba2-2.7b", "16x16", 0.658, 0.165),
]


@pytest.mark.parametrize("arch,mesh,params_gb,state_gb", PER_DEVICE_GB)
def test_per_device_bytes(arch, mesh, params_gb, state_gb):
    """The port's rules give each device the reference's bytes, exactly,
    and the table's numbers to its three decimals."""
    tm, jm = _meshes(mesh)
    sizes = dict(zip(*reversed(MESHES[mesh])))
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    specs = tapi.model_specs(tcfg)
    got_p = _per_device_gb(tapi.param_pspecs(tcfg, tm), specs, sizes, 2)
    want_p = _per_device_gb(
        tpm.tree_map(_ref, japi.param_pspecs(jcfg, jm)), specs, sizes, 2)
    state = topt.state_specs(specs)
    got_s = 2 * _per_device_gb(tpm.pspecs(state["m"], tm), state["m"],
                               sizes, 4)
    jstate = jopt.state_specs(japi.model_specs(jcfg))
    want_s = 2 * _per_device_gb(
        tpm.tree_map(_ref, jpm.pspecs(jstate["m"], jm)), state["m"], sizes,
        4)
    assert (got_p, got_s) == (want_p, want_s)
    assert round(got_p, 3) == params_gb and round(got_s, 3) == state_gb


def _slices(side):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "mesh_slice_cases.py"), side],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def slices():
    return _slices("port"), _slices("jax")


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2", "2x2x2-fused"])
def test_rank_slices_match_devices_indices_map(slices, mesh):
    """The slice each rank holds (DTensor's placement, the mesh's ranks in
    row-major order) is the slice ``NamedSharding.devices_indices_map``
    gives the device at the same mesh coordinate: a dim on ("pod", "data")
    is laid out pod-major on both sides, and so is the port's fused
    multi-pod mesh's "data" dim."""
    port, ref = slices
    got = {(c, tuple(x)): s for c, x, s in port[mesh]}
    want = {(c, tuple(x)): s for c, x, s in ref[mesh.split("-")[0]]}
    assert got == want and len(got) == 8 * 7


# ---------------------------------------- the JAX package's own tests -----
def test_zero_spec_adds_dp_axis():
    s = tpm.Spec((128, 64), ("embed", "mlp"))
    z = topt._zero_spec(s)
    assert "zero" in z.axes


def test_spec_divisibility_fallback():
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    assert shd.spec_for(mesh, (16, 32), ("embed", "mlp")) == (None, "model")
    # 24 does not divide 16: replicated
    assert shd.spec_for(mesh, (16, 24), ("embed", "mlp")) == ()


def test_spec_no_double_axis_use():
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    p = shd.spec_for(mesh, (16, 16, 16), ("experts", "embed", "expert_mlp"))
    flat = []
    for a in p:
        if a is not None:
            flat += list(a) if isinstance(a, tuple) else [a]
    assert flat == ["model"]


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert shd.constrain(x, "batch", None) is x
    with shd.use_mesh(shd.AbstractMesh((1, 1), ("data", "model"))):
        assert shd.constrain(x, "batch", None) is x        # a plain tensor


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = shd.spec_for(mesh, (256, 4096, 1024), ("batch", None, "mlp"))
    assert spec == (("pod", "data"), None, "model")
    assert shd.placements(mesh, spec) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shd.placements(mesh, (("data", "pod"),))


def test_abstract_trees_have_the_reference_shapes_and_dtypes():
    import jax
    cfg = treg.get_config("qwen3-0.6b").reduced()
    jcfg = jreg.get_config("qwen3-0.6b").reduced()
    got = tpm.tree_leaves(tapi.abstract_params(cfg))
    want = jax.tree_util.tree_leaves(japi.abstract_params(jcfg))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in got)
    cache = tapi.abstract_cache(cfg, 2, 16)
    jcache = japi.abstract_cache(jcfg, 2, 16)
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        assert tuple(cache[k].shape) == tuple(jcache[k].shape)
        assert str(cache[k].dtype).replace("torch.", "") == str(
            jcache[k].dtype)
        assert cache[k].device.type == "meta"
