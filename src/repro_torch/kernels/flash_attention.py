"""Flash attention for prefill: the Hopper kernel's wrapper and its plain
PyTorch version.

The kernel is ``csrc/flash_attention.cu``, CUDA C++ written for sm_90a and
bound through a plain C interface with ``ctypes``. It replaces the TPU kernel
``flash_attention`` -> ``_kernel`` of ``src/repro/kernels/flash_attention.py``;
the source's header says what bounds it on the H100 and what its design does
about that.

``flash_attention_plain`` is the same algorithm in plain PyTorch ops: the
Pallas kernel's loop over q blocks and kv blocks with the f32 online-softmax
state, tile skipping and the finite ``NEG_INF``, with ragged edges sliced
instead of asserted away. It runs for CPU tensors, and on the card it is what
the kernel is held against.

``flash_attention_cuda`` launches the kernel. It takes CUDA tensors only,
counts its launches in ``flash_attention_cuda.launches``, and raises when the
launch fails; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128, 256)   # the kernel's template instances
MAX_GROUP = 64              # q heads per kv head that fit its 64-row q tile


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,D) and k/v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not agree on batch, head_dim or head grouping")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_block: int = 128,
                          kv_block: int = 128) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,T,KH,D) -> (B,Sq,H,D) in q's dtype."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_block = min(q_block, sq)
    kv_block = min(kv_block, t)
    dev = q.device
    # (B,Sq,H,D) -> (B,KH,Sq*G,D), rows ordered (q position, group)
    qr = (q.reshape(b, sq, kh, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, kh, sq * g, d).float() * (d ** -0.5))
    kr = k.permute(0, 2, 1, 3).float()                  # (B,KH,T,D)
    vr = v.permute(0, 2, 1, 3).float()
    out = torch.empty(b, kh, sq * g, d, dtype=torch.float32, device=dev)
    n_kv = -(-t // kv_block)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        rows = qr[:, :, q0 * g:q1 * g]
        q_pos = (q0 + torch.arange((q1 - q0) * g, device=dev) // g)[:, None]
        m = torch.full((b, kh, rows.shape[2], 1), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, kh, rows.shape[2], d, device=dev)
        hi = min(-(-q1 // kv_block), n_kv) if causal else n_kv
        lo = max((q0 - window) // kv_block, 0) if window is not None else 0
        for ki in range(lo, hi):
            k0, k1 = ki * kv_block, min((ki + 1) * kv_block, t)
            s = rows @ kr[:, :, k0:k1].transpose(-1, -2)
            k_pos = torch.arange(k0, k1, device=dev)[None, :]
            ok = torch.ones_like(s, dtype=torch.bool)
            if causal:
                ok &= k_pos <= q_pos
            if window is not None:
                ok &= k_pos > q_pos - window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vr[:, :, k0:k1]
            m = m_new
        out[:, :, q0 * g:q1 * g] = acc / l.clamp_min(1e-30)
    return (out.reshape(b, kh, sq, g, d).permute(0, 2, 1, 3, 4)
            .reshape(b, sq, h, d).to(q.dtype))


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. The kernel picks
    its own tiles (64 q rows x 64 keys), so it takes no block sizes."""
    _check_shapes(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"the flash attention kernel takes CUDA tensors on "
                         f"one card; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"the flash attention kernel takes f32 or bf16 "
                         f"tensors of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS or h // kh > MAX_GROUP:
        raise ValueError(f"the flash attention kernel is built for head_dim "
                         f"in {HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head; got D={d}, G={h // kh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash attention kernel takes contiguous tensors")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0; got {window}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, t, h, kh, d, int(q.dtype == torch.bfloat16), int(causal),
            -1 if window is None else int(window), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.repro_cuda_error_string(err).decode()})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
