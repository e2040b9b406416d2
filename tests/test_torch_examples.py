"""The port's twins of ``examples/serve_fdn.py`` and
``examples/energy_aware_scheduling.py`` print the examples' bytes.

Each example runs whole through ``runpy`` in the JAX package, its twin's
``main`` in the port on the CPU, at the examples' own sizes (240 simulated
seconds of four virtual users per function; Table 4's 12,000 JSON-loads
per platform), with ``ExecutionModel.measure_real`` pinned to the same
seconds per function in both packages (``tests/example_pins.py``): both
examples time their real bodies once on the host's clock otherwise. Backend
pairs: numpy/numpy (float64 both) and jax/torch (float32 both); serve_fdn's
jax/torch pair also with K1's switch on (the CPU runs K1's plain version).
A torch run makes as many torch decisions as its reference makes JAX
decisions. Without a card and without ``device="cpu"`` each twin raises
``NoCudaDevice``."""
import contextlib
import io
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from example_pins import pinned_measure_real  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core.platform import ExecutionModel as JExec  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core.platform import ExecutionModel as TExec  # noqa: E402
from repro_torch.device import NoCudaDevice  # noqa: E402
from repro_torch.kernels import policy_score as tps  # noqa: E402
from repro_torch.launch import energy_aware_scheduling, serve_fdn  # noqa: E402,E501

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TWINS = {"serve_fdn": serve_fdn,
         "energy_aware_scheduling": energy_aware_scheduling}
# (example, reference backend, port backend, K1's switch)
CASES = [("serve_fdn", "numpy", "numpy", False),
         ("serve_fdn", "jax", "torch", False),
         ("serve_fdn", "jax", "torch", True),
         ("energy_aware_scheduling", "numpy", "numpy", False),
         ("energy_aware_scheduling", "jax", "torch", False)]

_reference = {}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(JExec, "measure_real", pinned_measure_real)
    monkeypatch.setattr(TExec, "measure_real", pinned_measure_real)
    yield
    jsched.set_score_backend("auto")


def reference(name: str, backend: str):
    """The example's stdout under the JAX package's ``backend`` and the
    decisions its policies made through ``_jax_decide`` (each admission and
    each prewarm choice of serve_fdn, the two choices of Table 4), once per
    module."""
    if (name, backend) not in _reference:
        calls = [0]
        with pytest.MonkeyPatch.context() as mp:
            for cls in (jsched.SLOCompositePolicy, jsched.EnergyAwarePolicy):
                decide = cls._jax_decide

                def counted(self, *args, _decide=decide, **kw):
                    calls[0] += 1
                    return _decide(self, *args, **kw)
                mp.setattr(cls, "_jax_decide", counted)
            jsched.set_score_backend(backend)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(EXAMPLES / f"{name}.py"),
                               run_name="__main__")
        _reference[name, backend] = buf.getvalue(), calls[0]
    return _reference[name, backend]


@pytest.mark.parametrize("name,jax_backend,torch_backend,kernel", CASES)
def test_twin_prints_the_example_bytes(name, jax_backend, torch_backend,
                                       kernel, monkeypatch):
    want, jax_decisions = reference(name, jax_backend)
    twin = TWINS[name]
    runs = []
    run = twin.run

    def recorded(*args, **kw):
        runs.append(run(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(twin, "run", recorded)
    argv = ["--device", "cpu", "--backend", torch_backend]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert twin.main(argv + ["--kernel"] * kernel) == 0
    assert buf.getvalue() == want
    out, = runs
    assert out["torch_decisions"] == jax_decisions
    assert (jax_decisions > 0) == (torch_backend == "torch")
    assert out.get("k1_launches", 0) == 0     # the CPU runs the plain K1
    # the run's settings are put back
    assert tsched.get_score_backend() == "auto"
    assert tsched.get_score_device() is None
    assert tps.use_pallas() is False


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_without_a_card_raises(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    twin = TWINS[name]
    with pytest.raises(NoCudaDevice, match="CUDA card"):
        twin.run()
    with pytest.raises(NoCudaDevice):
        twin.run("torch")
    assert twin.main([]) == 2
    captured = capsys.readouterr()
    assert "no CUDA card" in captured.err and not captured.out
