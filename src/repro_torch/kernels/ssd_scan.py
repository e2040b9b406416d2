"""Mamba-2 SSD chunked scan for prefill: the Hopper kernel's wrapper and its
plain PyTorch version.

The kernel is ``csrc/ssd_scan.cu``, CUDA C++ written for sm_90a and bound
through a plain C interface with ``ctypes``. It replaces the TPU kernel
``ssd_scan`` -> ``_kernel`` of ``src/repro/kernels/ssd_scan.py``; the
source's header says what bounds it on the H100 and what its design does
about that.

``ssd_scan_plain`` is the Pallas kernel's algorithm in plain PyTorch ops: a
loop over chunks that carries the (B,H,P,N) f32 state from one chunk to the
next, with the intra-chunk decay evaluated only where i >= j (so a large
|dt*A| cannot make inf there). It runs for CPU tensors, and on the card it is
what the kernel is held against.

``ssd_scan_cuda`` launches the kernel. For bf16 (the serving path) that is
two kernels a call (``BF16_KERNELS``): C.B^T once per group with the chunk
states and their recurrence, then the outputs; the wrapper allocates their
scratch (C.B^T in f32 and the states entering each chunk as bf16 hi + lo).
The bf16 route reads x, B and C through TMA tensor maps, so it takes head
dims and state widths that are multiples of 8 (every Mamba-2 configuration
has them). f32 takes one kernel. It takes CUDA tensors only, counts its calls in
``ssd_scan_cuda.launches``, and raises when a launch fails; it never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 128     # N: the kernel's per-thread state columns
MAX_CHUNK = 256     # Q: one step of the in-chunk scan per thread
BF16_KERNELS = 2    # kernels a bf16 call launches


def _check_shapes(x, dt, A, Bm, Cm, chunk):
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 or (
            Bm.shape != Cm.shape):
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), A (H,), B/C "
                         f"(B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or A.shape[0] != h
            or Bm.shape[:2] != (b, s) or h % Bm.shape[2] != 0):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} and B/C {tuple(Bm.shape)} do not "
                         f"agree on batch, sequence, heads or grouping")
    if chunk <= 0 or s % chunk != 0:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,G,N). Returns
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    b, s, h, p = x.shape
    hpg = h // Bm.shape[2]
    n = Bm.shape[3]
    dev = x.device
    a = A.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=dev).tril()[None, :, :, None]
    state = torch.zeros(b, h, p, n, device=dev)
    ys = []
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk].float()                    # (B,Q,H,P)
        dtc = dt[:, c0:c0 + chunk].float()                  # (B,Q,H)
        bc = Bm[:, c0:c0 + chunk].float().repeat_interleave(hpg, dim=2)
        cc = Cm[:, c0:c0 + chunk].float().repeat_interleave(hpg, dim=2)
        cum = torch.cumsum(dtc * a, dim=1)                  # (B,Q,H)
        total = cum[:, -1]                                  # (B,H)
        # L[i, j] = exp(cum_i - cum_j) for i >= j, 0 above the diagonal
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,Q,H)
        L = torch.exp(torch.where(tri, diff, float("-inf")))
        cb = torch.einsum("bihn,bjhn->bijh", cc, bc)
        w = cb * L * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + (torch.einsum("bihn,bhpn->bihp", cc, state)
                 * torch.exp(cum)[..., None])
        xdt = xc * (dtc * torch.exp(total[:, None, :] - cum))[..., None]
        state = (state * torch.exp(total)[:, :, None, None]
                 + torch.einsum("bjhp,bjhn->bhpn", xdt, bc))
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_ssd_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream. x, B and C are
    bf16 or f32 (one dtype); dt and A are f32."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    tensors = (x, dt, A, Bm, Cm)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"the SSD scan kernel takes CUDA tensors on one "
                         f"card; got {[str(t.device) for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            Bm.dtype == Cm.dtype == x.dtype) or not (
            dt.dtype == A.dtype == torch.float32):
        raise ValueError(f"the SSD scan kernel takes x, B, C in f32 or bf16 "
                         f"(one dtype) and dt, A in f32; got {x.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}, {dt.dtype}, {A.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the SSD scan kernel takes contiguous tensors")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the SSD scan kernel is built for state width <= "
                         f"{MAX_STATE} and chunk <= {MAX_CHUNK}; got N={n}, "
                         f"chunk={chunk}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (p % 8 or n % 8
                 or any(t.data_ptr() % 16 for t in (x, Bm, Cm))):
        raise ValueError(f"the SSD scan kernel's bf16 route reads x, B and C "
                         f"by tensor maps: head dim and state width must be "
                         f"multiples of 8 and the data 16-byte aligned; got "
                         f"P={p}, N={n}")
    y = torch.empty_like(x)
    fin = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    nc = s // chunk
    # the bf16 route's scratch: C.B^T per (batch, chunk, group), its 64 x 64
    # tiles at or below the diagonal in f32 in the order of the second
    # kernel's register fragments, and the state entering each chunk as
    # bf16 hi + lo
    tiles = -(-chunk // 64)
    cb = torch.empty((b, nc, g, tiles * (tiles + 1) // 2, 4096) if bf16
                     else (0,), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, 2, p, n) if bf16 else (0,),
                         dtype=torch.bfloat16, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), fin.data_ptr(), cb.data_ptr(),
            states.data_ptr(), b, s, h, p, g, n, chunk, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {err} "
                           f"({lib.repro_ssd_error_string(err).decode()})")
    ssd_scan_cuda.launches += 1
    return y, fin


ssd_scan_cuda.launches = 0
