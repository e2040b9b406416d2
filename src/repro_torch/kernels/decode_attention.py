"""Split-K decode attention (one new token against a KV cache): the Hopper
kernel's wrapper and its plain PyTorch version.

The kernel is ``csrc/decode_attention.cu``, CUDA C++ written for sm_90a and
bound through a plain C interface with ``ctypes``. It replaces the TPU kernel
``decode_attention`` -> ``_kernel`` of
``src/repro/kernels/decode_attention.py`` and the cross-split combine of its
wrapper; the source's header says what bounds it on the H100 and what its
design does about that.

``split_rule`` is the reference wrapper's shape rule: it lowers ``splits``
until ``splits * kv_block`` divides T, clamps ``kv_block`` to the split's
length and rejects what the reference asserts away. Both routes call it, so
they accept and reject the same shapes.

``decode_attention_plain`` is the Pallas algorithm in plain PyTorch ops: per
(batch row, kv head, split) the loop over ``kv_block`` keys with the f32
online-softmax state (m, l, acc) and the finite ``NEG_INF`` mask, then the
combine of the splits by their global max. It runs for CPU tensors, and on
the card it is what the kernel is held against.

``decode_attention_cuda`` launches the kernel: one launch a call, the
splits of each (batch row, kv head) one thread-block cluster that combines
its partials in distributed shared memory, so the wrapper allocates only the
output. It takes CUDA tensors only, counts its launches in
``decode_attention_cuda.launches``, and raises when the launch fails; it
never falls back to the plain version. The kernel picks its own split count
(``kernel_splits``: about two blocks per SM of the card it runs on, at most
the cluster the card can co-schedule for the instance), which changes only
the rounding; ``splits``/``kv_block`` decide only which shapes it accepts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's template instances
MAX_GROUP = 64                   # q heads per kv head its shared memory holds
KEY_TILE = 32                    # keys per tile of the kernel
BLOCKS_PER_SM = 2                # the kernel's split target
MAX_SPLITS = 16                  # blocks of one cluster (Hopper's limit)
MMA_MIN_GROUP = 9                # bf16 groups this wide use the tensor cores


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,D) and k/v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not agree on batch, head_dim or head grouping")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"want lengths (B,) = ({b},); got "
                         f"{tuple(lengths.shape)}")


def split_rule(t: int, splits: int, kv_block: int) -> Tuple[int, int]:
    """The reference wrapper's (splits, kv_block) for a cache of T keys
    (``src/repro/kernels/decode_attention.py:69-73``): lower ``splits``
    while ``splits * kv_block`` does not divide T, clamp ``kv_block`` to
    T / splits, and reject the shape unless the splits then tile T."""
    if splits < 1 or kv_block < 1:
        raise ValueError(f"splits and kv_block must be >= 1; got splits="
                         f"{splits}, kv_block={kv_block}")
    s = splits
    while t % (s * kv_block) and s > 1:
        s -= 1
    blk = min(kv_block, t // s)
    if blk < 1 or t % s or (t // s) % blk:
        raise ValueError(f"decode attention cannot split T={t} keys with "
                         f"splits={splits}, kv_block={kv_block}: after "
                         f"lowering, splits={s}, kv_block={blk} do not tile "
                         f"T")
    return s, blk


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, splits: int = 4,
                           kv_block: int = 128) -> torch.Tensor:
    """q: (B,H,D); k,v: (B,T,KH,D); lengths: (B,). Returns (B,H,D) in q's
    dtype."""
    _check_shapes(q, k, v, lengths)
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    splits, kv_block = split_rule(t, splits, kv_block)
    split_len = t // splits
    dev = q.device
    qr = q.reshape(b, kh, 1, g, d).float() * (d ** -0.5)    # (B,KH,1,G,D)
    kr = k.permute(0, 2, 1, 3).float().reshape(b, kh, splits, split_len, d)
    vr = v.permute(0, 2, 1, 3).float().reshape(b, kh, splits, split_len, d)
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(b, 1, 1, 1, 1)
    base = (torch.arange(splits, device=dev) * split_len)[:, None, None]
    m = torch.full((b, kh, splits, g, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, kh, splits, g, d, device=dev)
    for ki in range(split_len // kv_block):
        blk = slice(ki * kv_block, (ki + 1) * kv_block)
        s = qr @ kr[:, :, :, blk].transpose(-1, -2)    # (B,KH,S,G,kv_block)
        k_pos = base + ki * kv_block + torch.arange(kv_block, device=dev)
        s = torch.where(k_pos < lens, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vr[:, :, :, blk]
        m = m_new
    # cross-split combine: renormalize the partials by the global max
    m_g = m.amax(2, keepdim=True)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(2)
    acc_g = (acc * w).sum(2)
    out = acc_g / l_g.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def kernel_splits(b: int, kh: int, t: int, target_blocks: int,
                  max_splits: int = MAX_SPLITS) -> Tuple[int, int]:
    """The kernel's (split count, keys a split): about ``target_blocks``
    blocks over (batch, kv head, split), at most ``max_splits`` (the
    cluster the card can co-schedule) and at most one split per
    KEY_TILE-key tile; the count is a power of two, the keys are spread
    evenly (the last split may hold fewer)."""
    want = min(max(1, -(-target_blocks // (b * kh))), -(-t // KEY_TILE),
               max_splits)
    n = 1 << (want.bit_length() - 1)
    return n, -(-t // n)


@functools.lru_cache(maxsize=None)
def _target_blocks(device: torch.device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return BLOCKS_PER_SM * sms


@functools.lru_cache(maxsize=None)
def _max_splits(device: torch.device, h: int, kh: int, d: int,
                bf16: bool) -> int:
    """The largest cluster (power of two <= MAX_SPLITS) that the card can
    co-schedule for the kernel instance of (G, D, dtype)."""
    lib = _library()
    with torch.cuda.device(device):
        n = lib.repro_decode_attention_max_splits(h, kh, d, int(bf16))
    if n < 1:
        raise RuntimeError(
            f"decode attention kernel: cluster query failed: CUDA error "
            f"{-n} ({lib.repro_decode_attention_error_string(-n).decode()})")
    return min(n, MAX_SPLITS)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_decode_attention_max_splits.argtypes = [ctypes.c_int] * 4
        lib.repro_decode_attention_max_splits.restype = ctypes.c_int
        lib.repro_decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.repro_decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, splits: int = 4,
                          kv_block: int = 128) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. ``splits`` and
    ``kv_block`` are checked by the reference's rule and decide nothing
    else: the kernel picks its own splits and tiles."""
    _check_shapes(q, k, v, lengths)
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    split_rule(t, splits, kv_block)
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError(f"the decode attention kernel takes CUDA tensors on "
                         f"one card; got {q.device}, {k.device}, {v.device}, "
                         f"lengths on {lengths.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"the decode attention kernel takes f32 or bf16 "
                         f"tensors of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"the decode attention kernel takes lengths as "
                         f"int32; got {lengths.dtype}")
    if d not in HEAD_DIMS or h // kh > MAX_GROUP:
        raise ValueError(f"the decode attention kernel is built for head_dim "
                         f"in {HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head; got D={d}, G={h // kh}")
    if not all(x.is_contiguous() for x in (q, k, v, lengths)):
        raise ValueError("the decode attention kernel takes contiguous "
                         "tensors")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the decode attention kernel reads q, k and v 16 "
                         "bytes at a time: they must start 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    n_splits, split_len = kernel_splits(
        b, kh, t, _target_blocks(q.device),
        _max_splits(q.device, h, kh, d, bf16))
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, t, h, kh, d, int(bf16), n_splits, split_len,
            d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(
            f"decode attention kernel launch failed: CUDA error {err} "
            f"({lib.repro_decode_attention_error_string(err).decode()})")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
