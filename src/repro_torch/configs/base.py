"""Model configuration dataclasses for every assigned architecture family.

A ``ModelConfig`` fully determines a model: family, dimensions, attention
geometry, MoE/SSM/hybrid extras, and the knobs the perf loop turns
(remat policy, attention chunk sizes, sharding strategy overrides).

Every architecture in ``repro_torch.configs`` is expressed as one of these;
the ``reduced()`` method derives a CPU-smoke-test-sized config of the same
family.

This is the PyTorch port's own copy of the JAX package's configs, field for
field, so that a config of one package compares equal to the other's. Fields
that only steer JAX compilation or sharding (``scan_layers``,
``unroll_scans``, ``seq_parallel``, ``decode_seq_shard``) are kept for that
parity and are not read by the port. ``remat`` picks the training path's
activation checkpointing (``models/transformer._remat``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Families understood by the model zoo.
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"   # RG-LRU + local attention (recurrentgemma)
SSM = "ssm"         # Mamba-2 SSD
ENCDEC = "encdec"   # whisper
VLM = "vlm"         # phi-3-vision: dense backbone + stub image frontend

FAMILIES = (DENSE, MOE, HYBRID, SSM, ENCDEC, VLM)


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str

    # core transformer dims
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention behaviour
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA window; None = full attention
    causal: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"       # "einsum" (one-hot dispatch, paper-naive)
                                   # | "sorted" (argsort+scatter, §Perf)
                                   # | "sorted_shmap" (shard_map, §Perf)
    decode_impl: str = "gspmd"     # "gspmd" | "shmap_flash" (§Perf: split-K
                                   # flash-decode over the seq-sharded cache)

    # hybrid (RG-LRU): repeating block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None
    conv_width: int = 4
    local_window: int = 2048

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_enc_frames: int = 0          # encoder sequence length (precomputed frames)

    # vlm
    n_img_tokens: int = 0          # stub frontend supplies this many embeddings

    # numerics / perf knobs (hillclimbed in §Perf)
    dtype: str = "bfloat16"
    attn_q_chunk: int = 1024       # query-block size for chunked attention
    attn_kv_chunk: int = 2048      # kv-block size for chunked attention
    remat: str = "dots"            # "none" | "dots" | "full"
    tie_embeddings: bool = False
    param_fsdp: bool = False       # shard params over data axes too (FSDP);
                                   # required when TP-only shards overflow HBM
    seq_parallel: bool = True      # §Perf: shard layer-boundary activations
                                   # over "model" on the seq dim (Megatron
                                   # SP) — removes 16x-redundant norm/
                                   # residual work per model shard
    scan_layers: bool = True       # lax.scan over layer stack (keeps HLO small)
    use_pallas: bool = False       # route hot ops through the port's
                                   # hand-written CUDA kernels (name kept
                                   # from the JAX configs for parity)
    logits_chunk: int = 0          # >0: chunked loss over vocab (memory opt)
    decode_seq_shard: bool = True  # shard long KV caches over "model" axis
    unroll_scans: bool = False     # fully unroll lax.scan loops — used by
                                   # the roofline harness so XLA cost
                                   # analysis sees every iteration

    # ---- derived helpers -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode a 500k context without a full-length cache?"""
        if self.family in (SSM, HYBRID):
            return True
        return self.sliding_window is not None

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Active params per token (differs from n_params for MoE)."""
        return _count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests (one fwd/train step)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 if not self.block_pattern
                           else len(self.block_pattern)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            attn_q_chunk=64,
            attn_kv_chunk=64,
            local_window=32,
            scan_layers=self.scan_layers,
        )
        if self.sliding_window is not None:
            kw["sliding_window"] = 64
        if self.family == MOE:
            # generous capacity so the toy config never drops tokens and
            # train/prefill/decode agree exactly (drop behaviour is covered
            # at the full configs / property tests)
            kw.update(n_experts=4, top_k=2, capacity_factor=8.0)
        if self.family == HYBRID:
            kw.update(lru_width=128)
        if self.family == SSM:
            kw.update(d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.family == ENCDEC:
            kw.update(n_enc_layers=2, n_enc_frames=32)
        if self.family == VLM:
            kw.update(n_img_tokens=8)
        return self.replace(**kw)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic per-family parameter count (embedding + blocks + head)."""
    d, L = cfg.d_model, cfg.num_layers
    n = cfg.vocab_size * d                      # embedding
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size                 # lm head

    def attn_params() -> int:
        return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d

    def mlp_params() -> int:
        return 3 * d * cfg.d_ff                 # gated (wi, wg, wo)

    if cfg.family in (DENSE, VLM):
        n += L * (attn_params() + mlp_params() + 2 * d) + d
    elif cfg.family == MOE:
        e = cfg.top_k if active_only else cfg.n_experts
        n += L * (attn_params() + e * 3 * d * cfg.d_ff
                  + d * cfg.n_experts + 2 * d) + d
    elif cfg.family == HYBRID:
        w = cfg.lru_width or d
        pat = cfg.block_pattern or ("rec",)
        n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "attn")
        n_rec = L - n_attn
        rec = 2 * d * w + w * cfg.conv_width + 3 * w + w * d  # branches+conv+lru
        n += n_rec * (rec + mlp_params() + 2 * d)
        n += n_attn * (attn_params() + mlp_params() + 2 * d) + d
    elif cfg.family == SSM:
        di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        g = cfg.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * ds + nh)
        conv = (di + 2 * g * ds) * cfg.ssm_conv_width
        n += L * (in_proj + conv + 2 * nh + di + di * d + 2 * d) + d
    elif cfg.family == ENCDEC:
        enc = cfg.n_enc_layers * (attn_params() + mlp_params() + 2 * d)
        dec = L * (2 * attn_params() + mlp_params() + 3 * d)
        n += enc + dec + 2 * d
    else:
        raise ValueError(cfg.family)
    return n


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) cell plus its step kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
