"""Admission decisions over the columnar ``PlatformSnapshot`` (paper
§3.1.3): the Scheduler's policy filter cascades, cost matrices and argmin
as torch ops, and the two hand-written Hopper kernels of the composite
decision.

Each function takes per-distinct-function matrices of shape (F, P) — F
functions being decided, P candidate platforms — plus per-platform or
per-function vectors, all tensors on one device, and returns the fused
decision

    (choice: (F,) int32 platform index, ok: (F,) bool any-feasible)

with ties broken to the lowest platform index, exactly like the NumPy
``Policy.score`` + row-argmin path in ``repro_torch.core.scheduler`` (which
stays as the parity oracle). Width: the inputs are float32 (costs) and
int32 (counts), as the JAX package computes without x64, while the NumPy
oracle is float64; costs within float32 eps of each other could in
principle flip an argmin. ``as_tensor`` makes that conversion at the
boundary.

The graceful-degrade cascades mirror the host policies:
  * utilization filter: drop loaded platforms unless that empties a row;
  * SLO feasibility: drop SLO-violating platforms unless that empties a
    row (per function).

The composite decision has two hand-written CUDA kernels for sm_90a, both
in ``csrc/policy_score.cu`` and sharing one device function (the source's
header says what bounds them on the H100 and what the design does about
it):

  K1 ``fused_composite_decide_pallas`` — estimator gates, prediction
     columns, filter cascade and argmin from the raw estimator state;
     replaces ``fused_composite_decide_pallas`` of the JAX package's
     ``kernels/policy_score.py``;
  K2 ``composite_decide_pallas`` — the same cascade and argmin over
     prebuilt columns; replaces ``composite_decide_pallas`` there.

On the admission path K1 takes a third route, ``fused_composite_decide_
staged``: host arrays in, numpy (choice, ok) out. Its eleven inputs and two
outputs share one pinned host block mapped into the card's address space
(``staging_layout`` places them, ``pack_inputs`` writes them), so a
decision makes no host-to-device copy and no device allocation, launches
K1 once on the block and syncs once.

The wrappers keep the JAX package's names and dispatch on the tensors'
device: a CUDA tensor launches the kernel (``*_cuda``, which counts its
launches and raises when a launch fails), a CPU tensor runs the kernel's
plain version, the torch twin ``fused_composite_decide`` /
``composite_decide``. ``set_use_pallas`` keeps the JAX package's switch
name; here it routes the composite decision through these hand-written
kernels.

Non-finite costs: every path here, the kernels included, maps a masked
cost that is NaN or +-inf to inf before the argmin (``_masked_argmin``),
as the NumPy path does; a row with no finite candidate returns choice 0
and ok False.
"""
from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_INT = torch.int32
_INF = float("inf")

# Filter-kill bitmask bits for the explain bundle. Values mirror
# ``repro_torch.core.scheduler.KILL_*`` (the kernels module stays
# importable without the core package, so the literals are repeated).
KILL_DEAD = 1    # platform failed / no replicas (alive mask)
KILL_UTIL = 2    # alive but dropped by the utilization filter
KILL_SLO = 4     # survived utilization but dropped by SLO feasibility

_use_pallas = False


def set_use_pallas(enabled: bool) -> None:
    """Route the composite decision through the hand-written CUDA kernel
    (K1) on the card."""
    global _use_pallas
    _use_pallas = bool(enabled)


def use_pallas() -> bool:
    return _use_pallas


def as_tensor(x, device) -> torch.Tensor:
    """One decision input on ``device`` at the width the decision computes
    in: floats as float32, integer counts as int32, masks as bool."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype == torch.bool:
        dtype = torch.bool
    elif t.dtype.is_floating_point:
        dtype = torch.float32
    else:
        dtype = _INT
    return t.to(device=device, dtype=dtype)


def weight_f32(energy_weight) -> float:
    """The energy weight rounded to float32 (as the JAX package's jit
    takes a Python float), kept as a Python number."""
    if isinstance(energy_weight, torch.Tensor):
        energy_weight = energy_weight.item()
    return float(np.float32(energy_weight))


# ---------------------------------------------------------------------------
# Shared argmin
# ---------------------------------------------------------------------------

def _masked_argmin(cost: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise argmin of ``where(mask, cost, inf)``; ok marks rows with at
    least one finite candidate. ``torch.argmin`` returns the first of equal
    minima, the first-lowest tie-break of ``np.argmin``."""
    masked = torch.where(mask, cost, _INF)
    finite = torch.isfinite(masked)
    masked = torch.where(finite, masked, _INF)    # NaN -> inf, like host
    return torch.argmin(masked, dim=1).to(_INT), finite.any(dim=1)


def _degrade(ok: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Per-row graceful degrade: rows where the filter left no candidate
    fall back to the unfiltered mask."""
    return torch.where(ok.any(dim=1, keepdim=True), ok, fallback)


# ---------------------------------------------------------------------------
# Per-policy decisions
# ---------------------------------------------------------------------------

def perf_ranked_decide(exec_s, alive):
    """§5.1.1: fastest alive platform per function."""
    return _masked_argmin(exec_s, alive)


def utilization_decide(exec_s, alive, unloaded):
    """§5.1.2: fastest among un-pressured platforms (degrade to alive)."""
    ok = _degrade(alive & unloaded[None, :], alive)
    return _masked_argmin(exec_s, ok)


def locality_decide(exec_s, data_s, alive):
    """§5.1.4: execution + data-access seconds."""
    return _masked_argmin(exec_s + data_s, alive)


def warm_decide(exec_s, data_s, warm_free, cold_start_s, alive):
    """Warm-pool-aware routing: execution + data-access seconds, plus the
    platform's cold-start penalty where the function has no idle warm
    replica standing by."""
    cold = torch.where(warm_free > 0.0, 0.0, cold_start_s[None, :])
    return _masked_argmin(exec_s + data_s + cold, alive)


def energy_decide(energy_j, p90_s, slo_s, alive):
    """§5.2: cheapest energy among SLO-feasible (degrade to alive)."""
    feasible = _degrade(alive & (p90_s <= slo_s[:, None]), alive)
    return _masked_argmin(energy_j, feasible)


def composite_decide(exec_s, data_s, p90_s, energy_j, alive, unloaded,
                     slo_s, energy_weight):
    """The full SLOCompositePolicy cascade: utilization mask -> SLO
    feasibility -> locality-adjusted latency + energy tie-break. K2's plain
    version."""
    ok = _degrade(alive & unloaded[None, :], alive)
    feasible = _degrade(ok & (p90_s <= slo_s[:, None]), ok)
    cost = (exec_s + data_s) + weight_f32(energy_weight) * energy_j
    return _masked_argmin(cost, feasible)


# ---------------------------------------------------------------------------
# Explain bundle: decision + provenance in one pass
# ---------------------------------------------------------------------------

def _masked_argmin_explain(cost, mask):
    """``_masked_argmin`` plus the provenance extras: the runner-up (best
    feasible candidate excluding the winner, -1 when fewer than two are
    feasible) and the runner-up margin (inf in that case)."""
    masked = torch.where(mask, cost, _INF)
    finite = torch.isfinite(masked)
    masked = torch.where(finite, masked, _INF)
    choice = torch.argmin(masked, dim=1).to(_INT)
    ok = finite.any(dim=1)
    col = torch.arange(masked.shape[1], dtype=_INT,
                       device=masked.device)[None, :]
    rest = torch.where(col == choice[:, None], _INF, masked)
    runner = torch.argmin(rest, dim=1).to(_INT)
    best2 = rest.min(dim=1).values
    chosen = torch.gather(masked, 1, choice[:, None].long())[:, 0]
    has2 = torch.isfinite(best2)
    margin = torch.where(has2, best2 - chosen, _INF)
    runner = torch.where(has2, runner, -1)
    return choice, ok, runner, margin


def composite_explain(exec_s, data_s, p90_s, energy_j, alive, unloaded,
                      slo_s, energy_weight):
    """``composite_decide`` returning the full explain bundle:

        (choice, ok, kill, runner, margin, cost)

    ``kill`` is a uint8 (F, P) filter-kill bitmask (KILL_DEAD / KILL_UTIL
    / KILL_SLO; 0 == feasible after graceful degrade), ``cost`` the
    unmasked score columns, ``runner``/``margin`` the runner-up platform
    and its cost gap. Same cascade arithmetic as ``composite_decide``."""
    ok = _degrade(alive & unloaded[None, :], alive)
    feasible = _degrade(ok & (p90_s <= slo_s[:, None]), ok)
    cost = (exec_s + data_s) + weight_f32(energy_weight) * energy_j
    zero = torch.zeros((), dtype=torch.uint8, device=cost.device)
    kill = (torch.where(~alive, KILL_DEAD, zero)
            | torch.where(alive & ~ok, KILL_UTIL, zero)
            | torch.where(ok & ~feasible, KILL_SLO, zero))
    choice, any_ok, runner, margin = _masked_argmin_explain(cost, feasible)
    return choice, any_ok, kill, runner, margin, cost


def fused_composite_decide(ewma_v, ewma_n, analytic_s, resp_h2, resp_n,
                           data_s, nodes, loaded_w, alive, unloaded,
                           slo_s, energy_weight):
    """The whole admission step from the raw columnar estimator state
    (``FunctionPerformanceModel.estimator_columns``): exec EWMA-vs-analytic
    gate, P90 marker-vs-bootstrap gate, energy from the platform power
    model, then the SLOComposite filter cascade + argmin. K1's plain
    version.

    Arithmetic mirrors ``predict_matrix`` + ``composite_decide`` op for op
    (same operand association), so the only divergence from the NumPy
    oracle is the float32 width."""
    exec_s = torch.where(ewma_n >= 3, ewma_v, analytic_s)
    p90_s = torch.where(resp_n >= 10, resp_h2, exec_s * 1.5)
    energy_j = (exec_s * nodes[None, :]) * loaded_w[None, :]
    ok = _degrade(alive & unloaded[None, :], alive)
    feasible = _degrade(ok & (p90_s <= slo_s[:, None]), ok)
    cost = (exec_s + data_s) + weight_f32(energy_weight) * energy_j
    return _masked_argmin(cost, feasible)


# ---------------------------------------------------------------------------
# K2: cascade + argmin over prebuilt columns (csrc/policy_score.cu)
# ---------------------------------------------------------------------------

def _check(name, shapes_dtypes, device):
    """Each (tensor, shape, dtype) must match and lie contiguous on
    ``device``."""
    for label, t, shape, dtype in shapes_dtypes:
        if t.device != device:
            raise ValueError(f"{name}: {label} lies on {t.device}; want "
                             f"every input on {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {label} is {tuple(t.shape)} "
                             f"{t.dtype}; want {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("policy_score")
    if lib.repro_composite_decide.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_fused_composite_decide.argtypes = (
            [ptr] * 11 + [ctypes.c_float, i32, i32, ptr, ptr, ptr])
        lib.repro_fused_composite_decide.restype = i32
        lib.repro_composite_decide.argtypes = (
            [ptr] * 7 + [i32, i32, ptr, ptr, ptr])
        lib.repro_composite_decide.restype = i32
        lib.repro_host_block_alloc.argtypes = [
            ctypes.c_size_t, ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
        lib.repro_host_block_alloc.restype = i32
        lib.repro_host_block_free.argtypes = [ptr]
        lib.repro_host_block_free.restype = i32
        lib.repro_policy_score_error_string.argtypes = [i32]
        lib.repro_policy_score_error_string.restype = ctypes.c_char_p
    return lib


def _outputs(f: int, device):
    return (torch.empty(f, dtype=_INT, device=device),
            torch.empty(f, dtype=torch.bool, device=device))


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.repro_policy_score_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def composite_decide_cuda(exec_s, data_s, p90_s, wenergy, alive, unloaded,
                          slo_s):
    """Launch K2 on PyTorch's current stream: cost = (exec + data) +
    wenergy, where ``wenergy`` is the energy column already multiplied by
    the float32 energy weight. Inputs: (F,P) float32 columns, (F,P) bool
    ``alive``, (P,) bool ``unloaded``, (F,) float32 ``slo_s``, all
    contiguous on one card."""
    if exec_s.ndim != 2 or not exec_s.is_cuda:
        raise ValueError(f"composite_decide_cuda takes (F,P) CUDA tensors; "
                         f"got {tuple(exec_s.shape)} on {exec_s.device}")
    f, p = exec_s.shape
    if p == 0:
        raise ValueError("composite_decide_cuda: no platform columns")
    fp, f32 = (f, p), torch.float32
    _check("composite_decide_cuda", [
        ("exec_s", exec_s, fp, f32), ("data_s", data_s, fp, f32),
        ("p90_s", p90_s, fp, f32), ("wenergy", wenergy, fp, f32),
        ("alive", alive, fp, torch.bool),
        ("unloaded", unloaded, (p,), torch.bool),
        ("slo_s", slo_s, (f,), f32)], exec_s.device)
    choice, ok = _outputs(f, exec_s.device)
    if f == 0:
        return choice, ok
    lib = _library()
    with torch.cuda.device(exec_s.device):
        stream = torch.cuda.current_stream(exec_s.device).cuda_stream
        err = lib.repro_composite_decide(
            exec_s.data_ptr(), data_s.data_ptr(), p90_s.data_ptr(),
            wenergy.data_ptr(), alive.data_ptr(), unloaded.data_ptr(),
            slo_s.data_ptr(), f, p, choice.data_ptr(), ok.data_ptr(),
            stream)
    _raise_on(lib, err, "composite_decide (K2)")
    composite_decide_cuda.launches += 1
    return choice, ok


composite_decide_cuda.launches = 0


def composite_decide_pallas(exec_s, data_s, p90_s, energy_j, alive,
                            unloaded, slo_s, energy_weight):
    """K2: the SLOComposite decision over prebuilt columns; the same
    contract (and the same first-lowest tie-break) as
    ``composite_decide``. The energy weight multiplies the energy column
    here, in float32, before the kernel adds it."""
    wenergy = weight_f32(energy_weight) * energy_j
    if exec_s.device.type == "cuda":
        return composite_decide_cuda(exec_s, data_s, p90_s,
                                     wenergy.contiguous(), alive, unloaded,
                                     slo_s)
    if exec_s.device.type == "cpu":
        return composite_decide(exec_s, data_s, p90_s, energy_j, alive,
                                unloaded, slo_s, energy_weight)
    raise ValueError(f"composite_decide_pallas runs on cuda or cpu "
                     f"tensors; got {exec_s.device}")


# ---------------------------------------------------------------------------
# K1: estimator gates + prediction columns + cascade + argmin
# (csrc/policy_score.cu)
# ---------------------------------------------------------------------------

def fused_composite_decide_cuda(ewma_v, ewma_n, analytic_s, resp_h2,
                                resp_n, data_s, nodes, loaded_w, alive,
                                unloaded, slo_s, energy_weight):
    """Launch K1 on PyTorch's current stream. Inputs: (F,P) float32
    ``ewma_v``, ``analytic_s``, ``resp_h2``, ``data_s``; (F,P) int32
    ``ewma_n``, ``resp_n``; (F,P) bool ``alive``; (P,) float32 ``nodes``,
    ``loaded_w``; (P,) bool ``unloaded``; (F,) float32 ``slo_s``, all
    contiguous on one card; ``energy_weight`` a number."""
    if analytic_s.ndim != 2 or not analytic_s.is_cuda:
        raise ValueError(f"fused_composite_decide_cuda takes (F,P) CUDA "
                         f"tensors; got {tuple(analytic_s.shape)} on "
                         f"{analytic_s.device}")
    f, p = analytic_s.shape
    if p == 0:
        raise ValueError("fused_composite_decide_cuda: no platform columns")
    fp, f32 = (f, p), torch.float32
    _check("fused_composite_decide_cuda", [
        ("ewma_v", ewma_v, fp, f32), ("ewma_n", ewma_n, fp, _INT),
        ("analytic_s", analytic_s, fp, f32), ("resp_h2", resp_h2, fp, f32),
        ("resp_n", resp_n, fp, _INT), ("data_s", data_s, fp, f32),
        ("nodes", nodes, (p,), f32), ("loaded_w", loaded_w, (p,), f32),
        ("alive", alive, fp, torch.bool),
        ("unloaded", unloaded, (p,), torch.bool),
        ("slo_s", slo_s, (f,), f32)], analytic_s.device)
    choice, ok = _outputs(f, analytic_s.device)
    if f == 0:
        return choice, ok
    lib = _library()
    with torch.cuda.device(analytic_s.device):
        stream = torch.cuda.current_stream(analytic_s.device).cuda_stream
        err = lib.repro_fused_composite_decide(
            ewma_v.data_ptr(), ewma_n.data_ptr(), analytic_s.data_ptr(),
            resp_h2.data_ptr(), resp_n.data_ptr(), data_s.data_ptr(),
            nodes.data_ptr(), loaded_w.data_ptr(), alive.data_ptr(),
            unloaded.data_ptr(), slo_s.data_ptr(),
            weight_f32(energy_weight), f, p, choice.data_ptr(),
            ok.data_ptr(), stream)
    _raise_on(lib, err, "fused_composite_decide (K1)")
    fused_composite_decide_cuda.launches += 1
    return choice, ok


fused_composite_decide_cuda.launches = 0


def fused_composite_decide_pallas(ewma_v, ewma_n, analytic_s, resp_h2,
                                  resp_n, data_s, nodes, loaded_w, alive,
                                  unloaded, slo_s, energy_weight):
    """K1: raw estimator state in, (choice, ok) out, one kernel on the
    card; the same contract as ``fused_composite_decide``."""
    args = (ewma_v, ewma_n, analytic_s, resp_h2, resp_n, data_s, nodes,
            loaded_w, alive, unloaded, slo_s, energy_weight)
    if analytic_s.device.type == "cuda":
        return fused_composite_decide_cuda(*args)
    if analytic_s.device.type == "cpu":
        return fused_composite_decide(*args)
    raise ValueError(f"fused_composite_decide_pallas runs on cuda or cpu "
                     f"tensors; got {analytic_s.device}")


# ---------------------------------------------------------------------------
# K1's staged route: one pinned block in, one sync out
# ---------------------------------------------------------------------------

# K1's arguments before the energy weight, then its outputs: name, the
# width the decision computes in, and the shape, of (F, P) cells, of (P,)
# platforms or of (F,) functions
STAGED_ARRAYS = tuple((name, np.dtype(dtype), kind) for name, dtype, kind in (
    ("ewma_v", np.float32, "fp"), ("ewma_n", np.int32, "fp"),
    ("analytic_s", np.float32, "fp"), ("resp_h2", np.float32, "fp"),
    ("resp_n", np.int32, "fp"), ("data_s", np.float32, "fp"),
    ("nodes", np.float32, "p"), ("loaded_w", np.float32, "p"),
    ("alive", np.bool_, "fp"), ("unloaded", np.bool_, "p"),
    ("slo_s", np.float32, "f"),
    ("choice", np.int32, "f"), ("ok", np.bool_, "f")))
STAGED_INPUTS = 11
STAGE_ALIGN = 16     # bytes: every array starts on a 16-byte boundary
MIN_BLOCK = 4096     # bytes of the smallest staging block


@functools.lru_cache(maxsize=256)
def staging_layout(f: int, p: int
                   ) -> Tuple[Mapping[str, Tuple[int, np.dtype, tuple]], int]:
    """Where each of K1's eleven inputs and two outputs lies in the
    staging block for an (F, P) decision: ``{name: (byte offset, dtype,
    shape)}`` (read-only) in ``STAGED_ARRAYS``' order, each array on a
    ``STAGE_ALIGN``-byte boundary, and the bytes the block needs."""
    shapes = {"fp": ((f, p), f * p), "p": ((p,), p), "f": ((f,), f)}
    layout, off = {}, 0
    for name, dtype, kind in STAGED_ARRAYS:
        shape, count = shapes[kind]
        layout[name] = (off, dtype, shape)
        off += -(-count * dtype.itemsize // STAGE_ALIGN) * STAGE_ALIGN
    return MappingProxyType(layout), off


def block_bytes(needed: int) -> int:
    """The size a staging block grows to: the next power of two of the
    bytes a decision needs, at least ``MIN_BLOCK``."""
    return max(MIN_BLOCK, 1 << max(needed - 1, 0).bit_length())


def stage_views(buf: np.ndarray, f: int, p: int) -> Dict[str, np.ndarray]:
    """numpy views of a uint8 block ``buf`` at ``staging_layout(f, p)``."""
    layout, nbytes = staging_layout(f, p)
    if buf.dtype != np.uint8 or buf.ndim != 1 or buf.size < nbytes:
        raise ValueError(f"a staging block of {nbytes} uint8 bytes is "
                         f"needed; got {buf.dtype} {buf.shape}")
    return {name: np.ndarray(shape, dtype, buf, off)
            for name, (off, dtype, shape) in layout.items()}


def _copy_in(views: Dict[str, np.ndarray], arrays) -> None:
    """Write K1's eleven host inputs into their views, at the decision's
    compute width, with the cast ``as_tensor`` makes (round to nearest
    f32, int32, bool)."""
    if len(arrays) != STAGED_INPUTS:
        raise ValueError(f"K1 takes {STAGED_INPUTS} inputs; got "
                         f"{len(arrays)}")
    for (name, _, _), x in zip(STAGED_ARRAYS, arrays):
        view = views[name]
        if np.shape(x) != view.shape:
            raise ValueError(f"{name} is {np.shape(x)}; want {view.shape}")
        np.copyto(view, x, casting="unsafe")


def pack_inputs(buf: np.ndarray, *arrays) -> Dict[str, np.ndarray]:
    """Write K1's eleven host inputs (``fused_composite_decide``'s order)
    into the block ``buf`` at ``staging_layout`` and return the views of
    all thirteen arrays (``_copy_in``)."""
    if len(arrays) != STAGED_INPUTS:
        raise ValueError(f"K1 takes {STAGED_INPUTS} inputs; got "
                         f"{len(arrays)}")
    views = stage_views(buf, *np.shape(arrays[2]))
    _copy_in(views, arrays)
    return views


class _StagingBlock:
    """The process-wide pinned host block of the staged route, mapped into
    the card's address space. It grows (to ``block_bytes``) and never
    shrinks; every decision syncs before it returns, so no kernel reads
    the block when it is rewritten or freed. Decisions are made from one
    thread."""

    def __init__(self):
        self.host = None
        self.dev_ptr = 0
        self.buf = np.zeros(0, np.uint8)
        self.device = None
        self._views: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}

    def views(self, f: int, p: int) -> Dict[str, np.ndarray]:
        """The block's views at ``staging_layout(f, p)``, made once."""
        got = self._views.get((f, p))
        if got is None:
            got = self._views[(f, p)] = stage_views(self.buf, f, p)
        return got

    def ensure(self, nbytes: int, device: torch.device) -> None:
        if self.buf.size >= nbytes and self.device == device:
            return
        lib = _library()
        size = block_bytes(nbytes)
        self.release()
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            err = lib.repro_host_block_alloc(size, ctypes.byref(host),
                                             ctypes.byref(dev))
        if err != 0:
            msg = lib.repro_policy_score_error_string(err).decode()
            raise RuntimeError(f"K1's staging block ({size} bytes of pinned "
                               f"host memory mapped to {device}) could not "
                               f"be allocated: CUDA error {err} ({msg})")
        self.host, self.dev_ptr, self.device = host.value, dev.value, device
        self.buf = np.ctypeslib.as_array(
            (ctypes.c_uint8 * size).from_address(self.host))

    def release(self) -> None:
        if self.host is None:
            return
        lib = _library()
        err = lib.repro_host_block_free(self.host)
        self.host, self.dev_ptr, self.device = None, 0, None
        self.buf = np.zeros(0, np.uint8)
        self._views.clear()
        if err != 0:
            msg = lib.repro_policy_score_error_string(err).decode()
            raise RuntimeError(f"freeing K1's staging block failed: CUDA "
                               f"error {err} ({msg})")


_STAGING = _StagingBlock()


def fused_composite_decide_staged(ewma_v, ewma_n, analytic_s, resp_h2,
                                  resp_n, data_s, nodes, loaded_w, alive,
                                  unloaded, slo_s, energy_weight, device
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """K1 on the card ``device`` from host arrays (the contract of
    ``fused_composite_decide``): the inputs are written into the staging
    block, K1 reads them there and writes (choice, ok) back, and one sync
    of the current stream precedes the numpy copies returned. No
    host-to-device copy and no device allocation; the launch counts on
    ``fused_composite_decide_cuda.launches``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the staged K1 route runs on a CUDA card; got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    arrays = (ewma_v, ewma_n, analytic_s, resp_h2, resp_n, data_s, nodes,
              loaded_w, alive, unloaded, slo_s)
    if np.ndim(analytic_s) != 2:
        raise ValueError(f"the staged K1 route takes (F,P) columns; got "
                         f"{np.shape(analytic_s)}")
    f, p = np.shape(analytic_s)
    if p == 0:
        raise ValueError("fused_composite_decide_staged: no platform "
                         "columns")
    if f == 0:
        return np.zeros(0, np.int32), np.zeros(0, bool)
    layout, nbytes = staging_layout(f, p)
    _STAGING.ensure(nbytes, device)
    views = _STAGING.views(f, p)
    _copy_in(views, arrays)
    base = _STAGING.dev_ptr
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        err = lib.repro_fused_composite_decide(
            *(base + layout[name][0] for name, _, _ in
              STAGED_ARRAYS[:STAGED_INPUTS]),
            weight_f32(energy_weight), f, p, base + layout["choice"][0],
            base + layout["ok"][0], stream.cuda_stream)
        _raise_on(lib, err, "fused_composite_decide (K1, staged)")
        fused_composite_decide_cuda.launches += 1
        stream.synchronize()
    return views["choice"].copy(), views["ok"].copy()
