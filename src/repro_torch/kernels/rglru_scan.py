"""RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for prefill: the
Hopper kernel's wrapper and its plain PyTorch version.

The kernel is ``csrc/rglru_scan.cu``, CUDA C++ written for sm_90a and bound
through a plain C interface with ``ctypes``. It replaces the TPU kernel
``rglru_scan`` -> ``_kernel`` of ``src/repro/kernels/rglru_scan.py``; the
source's header says what bounds it on the H100 and what its design does
about that.

``rglru_scan_plain`` is the recurrence as its oracle defines it
(``kernels/ref.rglru_ref``, the twin of the JAX package's): a loop over the
sequence in f32, with no log-space rewrite. It runs for CPU tensors, and on
the card it is what the kernel is held against.

``rglru_scan_cuda`` launches the kernel. It takes CUDA tensors only, counts
its launches in ``rglru_scan_cuda.launches``, and raises when the launch
fails; it never falls back to the plain version. The kernel loads its tiles
by TMA, which needs every row of a and b on 16 bytes: it takes widths that
are multiples of 4 and 16-byte aligned data, and raises ``ValueError``
otherwise.

``kernel_tiles`` is the kernel's sizing rule: how many rows a block
holds a step, and how many steps its ring of tiles keeps in flight.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_ref


WARPS = 8           # sequence segments a tile, one per warp
MAX_TILE = 256      # rows a tile the kernel takes (a TMA box's limit)
MAX_STAGES = 4      # tiles in flight a block the kernel takes


def kernel_tiles(s: int) -> Tuple[int, int]:
    """(tile, stages) for a sequence of ``s`` rows: each block walks the
    sequence alone in steps of ``tile`` rows (a multiple of ``WARPS``),
    with a ring of ``stages`` tiles in flight, and carries the state from
    one step to the next. 256 rows a step with 3 in flight up to S = 1024
    (the longest serving bucket), 128 rows with 2 in flight beyond; a
    shorter sequence takes one tile of its own length. Picked on the H100
    among tiles of 32-256 rows and rings of 1-4 at S = 16-4096."""
    if s < 1:
        raise ValueError(f"the RG-LRU scan takes S >= 1; got {s}")
    tile, stages = (MAX_TILE, 3) if s <= 1024 else (128, 2)
    tile = min(tile, -(-s // WARPS) * WARPS)
    return tile, min(stages, -(-s // tile))


def _check_shapes(a: torch.Tensor, b: torch.Tensor):
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"want a, b of one shape (B,S,W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B,S,W) -> h (B,S,W) f32, h_t = a_t*h_{t-1} + b_t, h_{-1} = 0."""
    _check_shapes(a, b)
    return rglru_ref(a, b)


def _library() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_rglru_error_string.argtypes = [ctypes.c_int]
        lib.repro_rglru_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream: one block per
    strip of 32 columns of a batch row, in steps of ``kernel_tiles``."""
    _check_shapes(a, b)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"the RG-LRU scan kernel takes CUDA tensors on one "
                         f"card; got {a.device}, {b.device}")
    if not (a.dtype == b.dtype == torch.float32):
        raise ValueError(f"the RG-LRU scan kernel takes f32 tensors; got "
                         f"{a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the RG-LRU scan kernel takes contiguous tensors")
    bs, s, w = a.shape
    if w % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"the RG-LRU scan kernel loads rows by TMA: it "
                         f"takes widths that are multiples of 4 and 16-byte "
                         f"aligned data; got W={w}")
    tile, stages = kernel_tiles(s)
    h = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_rglru_scan_fwd(a.data_ptr(), b.data_ptr(),
                                       h.data_ptr(), bs, s, w, tile, stages,
                                       stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU scan kernel launch failed: CUDA error "
                           f"{err} "
                           f"({lib.repro_rglru_error_string(err).decode()})")
    rglru_scan_cuda.launches += 1
    return h


rglru_scan_cuda.launches = 0
