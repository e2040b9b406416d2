"""The port's ``make_train_step`` against the JAX package's, over three
steps on ``TokenStream`` batches 0-2, checked after the first and the third,
with one and two microbatches and with int8 gradient compression on and off
(every arch two of the four, qwen3-0.6b all four), in f32, for the reduced
configs of tests/train_cases.py (bf16: tests/test_torch_train_steps_bf16.py);
and the JAX package's training resumed in the port from its carried-across
parameters and optimizer state.

Tolerances. AdamW normalises each gradient element by its own RMS, so an
element whose gradient is near ``eps`` (1e-8), whose gradient's sign differs
between the two packages, or (with compression) whose int8 quantum rounds
the other way, takes a step up to ``lr`` or ``2 * lr`` away from the
reference's; every other element follows it closely. So each check has two
tiers, over the parameters after step t with ``S = sum(lr_1..lr_t)``: every
element within a hard bound, and a share of all the tree's elements within
a tight one (measured on the reduced configs at the shares' side):

* f32: hard 2e-5 rel + ``2.1 * S`` (an AdamW step of steps 1-3 moves at
  most 1.0003 * lr; measured: at most 0.48 of it), tight 1e-6 rel +
  ``1e-3 * S`` for 99.9% (measured: at most 0.030% beyond, reduced mixtral
  with compression after three steps). Loss 2e-5 rel; grad norm 2e-5 rel,
  5e-4 with compression (a flipped int8 quantum moves it; measured 8.1e-5).
* bf16: hard one bf16 ulp + ``2.1 * S`` (measured: at most 0.96 of it),
  tight one ulp + ``0.05 * S`` (bf16 gradients differ by a few percent)
  for 98% after the first step (measured: at most 0.74% beyond, reduced
  mixtral, whose bf16 routing differs from the reference's for some
  tokens) and 90% after the third (measured: at most 5.5% beyond, mixtral;
  0.4-2.7% for the others). Loss 2**-6 rel; grad norm 2**-5 rel (measured
  1.1e-2, mixtral after three steps).

The optimizer itself, on the same parameters and gradients, is held within
a few f32 ulps and one bf16 ulp in tests/test_torch_train.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import train_cases as tc  # noqa: E402
from repro.models import model_api as japi  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.models import model_api as tapi  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from train_cases import jax_params, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,mb,compress", tc.step_cases("f32"))
def test_train_steps_match_reference(jax_params, arch, mb, compress):
    tc.run_steps(jax_params, arch, "f32", mb, compress)


def test_microbatches_average_the_loss(jax_params):
    """Two microbatches: the loss is the mean of the two halves' losses,
    each half's own mean over its unmasked positions (f32)."""
    _, _, tcfg, tp = tc.setup(jax_params, "qwen3-0.6b", "f32")
    b = tc.torch_batch(tc.batch(tcfg))
    n = tc.BATCH // 2
    ls = [float(tapi.loss_fn(tcfg, tp, {k: v[i * n:(i + 1) * n]
                                        for k, v in b.items()})[0])
          for i in range(2)]
    to = topt.OptConfig(**tc.OC)
    _, _, m = tts.make_train_step(tcfg, to, 2)(
        tp, topt.init_state(to, tapi.model_specs(tcfg), "cpu"), b)
    assert float(m["loss"]) == pytest.approx(sum(ls) / 2, rel=1e-6)


def test_resume_reference_training_in_the_port(jax_params):
    """The JAX package trains two steps; its parameters and optimizer state
    are carried across; the third step in the port matches the JAX
    package's third (f32, the first-step tolerance with the third step's
    learning rate)."""
    jcfg, jp, tcfg, _ = tc.setup(jax_params, "qwen3-0.6b", "f32")
    jo, to = jopt.OptConfig(**tc.OC), topt.OptConfig(**tc.OC)
    js = jopt.init_state(jo, japi.model_specs(jcfg))
    jstep = jax.jit(jts.make_train_step(jcfg, jo))
    for i in range(2):
        jp, js, _ = jstep(jp, js, tc.jax_batch(tc.batch(jcfg, seed=i)))
    host = jax.tree_util.tree_map(np.asarray, {"p": jp, "s": js})
    tp = params_from_numpy(tcfg, host["p"], dtype=torch.float32,
                           device="cpu")
    ts = opt_state_from_numpy(tcfg, host["s"], device="cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    tc.close_tree(ts["m"], js["m"], tc.within(0))
    b = tc.batch(jcfg, seed=2)
    jp, js, jm = jstep(jp, js, tc.jax_batch(b))
    tp, ts, tm = tts.make_train_step(tcfg, to)(tp, ts, tc.torch_batch(b))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-5)
    lr3 = float(topt.schedule(to, torch.tensor(3)))
    tc.check_params(tp, jp, "f32", lr3, 1)
