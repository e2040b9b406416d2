"""The port's ``make_train_step`` against the JAX package's in bf16: three
steps on ``TokenStream`` batches 0-2, checked after the first and the
third, with two microbatches and int8 gradient compression (qwen3-0.6b also
with one microbatch and none), for the reduced configs of
tests/train_cases.py, at the bf16 tolerances that
tests/test_torch_train_steps.py states."""
import pytest

torch = pytest.importorskip("torch")

import train_cases as tc  # noqa: E402
from train_cases import jax_params, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,mb,compress", tc.step_cases("bf16"))
def test_train_steps_match_reference(jax_params, arch, mb, compress):
    tc.run_steps(jax_params, arch, "bf16", mb, compress)
