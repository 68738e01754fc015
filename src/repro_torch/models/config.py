"""Model configuration: ``ModelConfig``, ``MoESpec``, ``InputShape``.

Own copy of ``src/repro/models/config.py`` (the dataclasses are verbatim, so a
config of one package equals the other's field by field).  A model is a
*pattern* of homogeneous block stacks; a stack's parameters carry a leading
layer dim and the port runs the stack as a Python loop over it.

Block kinds (all ported, ``models/blocks.py``):
  attn       full causal attention + SwiGLU FFN
  swa        sliding-window attention + SwiGLU FFN
  moe        full attention + top-k MoE FFN
  moe_swa    sliding-window attention + top-k MoE FFN
  hymba_g    parallel (full attention || Mamba SSM heads) + FFN
  hymba_l    parallel (SWA attention || Mamba SSM heads) + FFN
  mlstm      xLSTM matrix-memory block (chunkwise-parallel, no FFN)
  slstm      xLSTM scalar-memory block (recurrent, no FFN)
  enc        bidirectional encoder attention + FFN (no cache)
  xdec       decoder self-attention + cross-attention + FFN
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

FULL_ATTN_KINDS = ("attn", "moe", "enc", "xdec", "hymba_g")
CACHED_KINDS = ("attn", "swa", "moe", "moe_swa", "hymba_g", "hymba_l",
                "mlstm", "slstm", "xdec")


@dataclass(frozen=True)
class MoESpec:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ()             # ((kind, count), ...) — decoder stack
    enc_pattern: tuple = ()         # encoder stack (enc-dec archs)
    head_dim: int = 0               # 0 => d_model // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 4096
    moe: Optional[MoESpec] = None
    # -- SSM / hybrid --
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 1             # d_inner = expand * d_model
    # -- xLSTM --
    qk_dim: int = 0                 # mLSTM q/k head dim (0 => head_dim // 2)
    # -- VLM --
    mrope_sections: tuple = ()      # e.g. (16, 24, 24); empty => 1D RoPE
    # -- I/O --
    input_mode: str = "tokens"      # tokens | embeds | encdec
    tie_embeddings: bool = False
    embed_scale: float = 1.0        # MiniCPM scale_emb
    residual_scale: float = 1.0     # MiniCPM depth scaling (1.4/sqrt(L))
    logit_scale: float = 1.0        # MiniCPM: dim_base / d_model
    # -- numerics / structure --
    dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full
    # attention implementation (the §Perf memory-term lever):
    #   einsum   — reference: materializes (S, S) scores in fp32
    #   bf16     — bf16 score storage, fp32 softmax reductions only
    #   qchunk   — flash-style query blocking: (Sq/chunk, S) transients,
    #              block-skips fully-masked causal/window tiles
    attn_impl: str = "einsum"
    attn_chunk: int = 512
    # MoE dispatch: "global" (pjit global-view scatter — the baseline) or
    # "sharded" (shard_map-local dispatch per data shard — §Perf fix; needs
    # distributed.context.shard_context at trace time)
    moe_impl: str = "global"
    scan_chunk: int = 128           # SSM / mLSTM chunkwise length
    # dry-run accounting: unroll layer-stack & loss scans so
    # compiled.cost_analysis() sees every layer (XLA's HLO cost analysis
    # counts while-loop bodies once); inner recurrence scans stay rolled
    # and are corrected analytically (launch/roofline.py).
    scan_unroll: bool = False
    max_target_len: int = 32768     # decoder length cap for enc-dec decode

    # ------------------------------------------------------------------ props
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def qk(self) -> int:
        return self.qk_dim or max(self.hd // 2, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def decoder_layers(self) -> int:
        return sum(n for _, n in self.pattern)

    def encoder_layers(self) -> int:
        return sum(n for _, n in self.enc_pattern)

    @property
    def subquadratic(self) -> bool:
        """True iff decode state does NOT grow linearly-with-full-attention:
        every cached decoder block is windowed or recurrent."""
        return all(k in ("swa", "moe_swa", "mlstm", "slstm", "hymba_l", "hymba_g")
                   for k, _ in self.pattern) and not any(
                       k in ("attn", "moe", "xdec") for k, _ in self.pattern)

    @property
    def long_context_ok(self) -> bool:
        """Eligible for the long_500k cell: no block needs an unbounded dense
        KV cache — hymba_g (a handful of global layers) is tolerated because
        its cache is linear in exactly len(hymba_g) layers (documented)."""
        return not any(k in ("attn", "moe", "xdec", "enc") for k, _ in self.pattern)

    # ------------------------------------------------------------ param count
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.n_heads, self.n_kv_heads, self.hd
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += d * v                 # lm head
        total += d                         # final norm

        def attn_params() -> int:
            return d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d  # q,k,v,o + norms

        def ffn_params() -> int:
            return 3 * d * f

        def moe_params() -> int:
            assert self.moe is not None
            return self.moe.n_experts * 3 * d * f + d * self.moe.n_experts

        def ssm_params() -> int:
            di, n = self.d_inner, self.ssm_state
            return (2 * d * di + di * self.ssm_conv_width
                    + di * (2 * n + 2) + di * n + di + di * d)

        def mlstm_params() -> int:
            hq = self.qk * self.n_heads
            hv = self.hd * self.n_heads
            return d * (2 * hq + 2 * hv) + 3 * self.n_heads * d + hv * d + 2 * d

        def slstm_params() -> int:
            hv = self.hd * self.n_heads
            return 4 * d * hv + 4 * self.n_heads * self.hd ** 2 + hv * d + 2 * d

        per_kind = {
            "attn": lambda: attn_params() + ffn_params(),
            "swa": lambda: attn_params() + ffn_params(),
            "moe": lambda: attn_params() + moe_params(),
            "moe_swa": lambda: attn_params() + moe_params(),
            "hymba_g": lambda: attn_params() + ssm_params() + ffn_params(),
            "hymba_l": lambda: attn_params() + ssm_params() + ffn_params(),
            "mlstm": mlstm_params,
            "slstm": slstm_params,
            "enc": lambda: attn_params() + ffn_params(),
            "xdec": lambda: 2 * attn_params() + ffn_params(),
        }
        for kind, n in tuple(self.pattern) + tuple(self.enc_pattern):
            total += n * per_kind[kind]()
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(n for k, n in self.pattern if k.startswith("moe"))
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * self.d_model * self.d_ff
        return full - n_moe_layers * inactive


@dataclass(frozen=True)
class InputShape:
    """One assigned input-shape cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def uniform_pattern(kind: str, n: int) -> tuple:
    return ((kind, n),)


def grouped_pattern(groups: int, *entries: tuple) -> tuple:
    """e.g. grouped_pattern(6, ("mlstm", 7), ("slstm", 1)) -> 12 stacks."""
    return tuple(entries) * groups
