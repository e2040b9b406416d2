"""The port's checkpointer (``checkpoint/checkpointer.py``) against the JAX
package's: the same layout and keys, so that each package restores the
other's checkpoints; round trips bit for bit (bf16 widened to f32 on disk
and cast back on restore); ``retain``, ``async_save`` and ``.tmp``
directories never listed; ``save`` copies before it returns."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.train import optimizer as topt  # noqa: E402
from train_cases import one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def trees():
    """The same training state in both packages: reduced qwen3's bf16
    parameters and an AdamW state (f32 m and v, int32 step) after one
    update of the JAX package, carried across."""
    jcfg = jreg.get_config(ARCH).reduced()
    tcfg = treg.get_config(ARCH).reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    oc = jopt.OptConfig(compress_grads=True)
    js = jopt.init_state(oc, japi.model_specs(jcfg))
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                                   jp)
    jp, js, _ = jopt.apply_updates(oc, jp, grads, js)
    host = jax.tree_util.tree_map(np.asarray, {"p": jp, "s": js})
    tp = params_from_numpy(tcfg, host["p"], device="cpu")
    ts = opt_state_from_numpy(tcfg, host["s"], device="cpu")
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}, tcfg


def _fresh(tcfg):
    """A tree of the training state's structure, of other values."""
    p = tapi.init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    s = topt.init_state(topt.OptConfig(compress_grads=True),
                        tapi.model_specs(tcfg), "cpu")
    return {"params": p, "opt": s}


def _assert_bit_equal(got, want):
    g, w = tpm.tree_leaves(got), tpm.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _assert_jax_equal(got, want):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_exact(trees, tmp_path, async_save):
    _, tree, tcfg = trees
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    ck.save(3, tree, extra={"arch": tcfg.name})
    ck.wait()
    assert ck.latest_step() == 3 and ck.extra(3) == {"arch": tcfg.name}
    back = ck.restore(3, _fresh(tcfg))
    _assert_bit_equal(back, tree)
    assert back["params"]["embed"].dtype == torch.bfloat16
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 1


def test_layout_and_keys_are_the_reference(trees, tmp_path):
    jtree, ttree, _ = trees
    Checkpointer(str(tmp_path / "t")).save(5, ttree)
    jckpt.Checkpointer(str(tmp_path / "j")).save(5, jtree)
    for d in ("t", "j"):
        assert sorted(os.listdir(tmp_path / d / "step_5")) == [
            "arrays.npz", "manifest.json"]
    mt = json.loads((tmp_path / "t/step_5/manifest.json").read_text())
    mj = json.loads((tmp_path / "j/step_5/manifest.json").read_text())
    assert mt == mj
    assert "params/layers/attn/wq" in mt["keys"]
    assert "opt/step" in mt["keys"] and "opt/ef/embed" in mt["keys"]
    # bf16 leaves are stored widened to f32, in both packages
    assert mt["dtypes"][mt["keys"].index("params/embed")] == "float32"


def test_the_reference_restores_the_ports_checkpoint(trees, tmp_path):
    jtree, ttree, _ = trees
    Checkpointer(str(tmp_path)).save(7, ttree)
    back = jckpt.Checkpointer(str(tmp_path)).restore(7, jtree)
    _assert_jax_equal(back, jtree)
    assert str(jax.tree_util.tree_leaves(back["params"])[0].dtype) == \
        "bfloat16"


def test_the_port_restores_the_references_checkpoint(trees, tmp_path):
    jtree, ttree, tcfg = trees
    jckpt.Checkpointer(str(tmp_path)).save(7, jtree)
    _assert_bit_equal(Checkpointer(str(tmp_path)).restore(7, _fresh(tcfg)),
                      ttree)


def test_restore_places_on_the_asked_device(trees, tmp_path):
    _, tree, tcfg = trees
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    back = ck.restore(1, _fresh(tcfg), device="cpu")
    assert all(t.device.type == "cpu" for t in tpm.tree_leaves(back))
    with pytest.raises(KeyError, match="missing key"):
        ck.restore(1, {"params": {"nope": torch.zeros(1)}})


def test_retain_keeps_the_newest_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), retain=2)
    for s in range(1, 6):
        ck.save(s, {"w": torch.full((3,), float(s))})
    assert ck.all_steps() == [4, 5]
    assert float(ck.restore(5, {"w": torch.zeros(3)})["w"][0]) == 5.0


def test_tmp_directories_are_never_listed(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    os.makedirs(tmp_path / "step_9.tmp")           # a write cut short
    (tmp_path / "step_9.tmp" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_8")               # no manifest yet
    assert ck.all_steps() == [] and ck.latest_step() is None
    ck.save(2, {"w": torch.ones(4)})
    ck.wait()
    assert ck.all_steps() == [2]
    assert not os.path.exists(tmp_path / "step_2.tmp")


def test_async_save_copies_before_it_returns(tmp_path):
    """The training loop may overwrite its tensors while the writer thread
    runs: the checkpoint holds the values at the call."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    ck.save(1, {"w": w, "b": b})
    w.zero_()
    b.mul_(3)
    ck.save(2, {"w": w, "b": b})                   # waits for the first
    ck.wait()
    first = ck.restore(1, {"w": w, "b": b})
    assert torch.equal(first["w"], torch.arange(1 << 16,
                                                dtype=torch.float32))
    assert torch.equal(first["b"], torch.ones(8, dtype=torch.bfloat16))
    assert float(ck.restore(2, {"w": w, "b": b})["b"][0]) == 3.0
