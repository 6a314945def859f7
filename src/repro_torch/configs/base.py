"""Architecture configuration: the port's copy of ``repro.configs.base``
with the fields that the models, the steps and :meth:`ArchConfig.reduced`
read, the benchmark shapes (:class:`ShapeConfig`, ``SHAPES``,
:func:`shape_applicable`), and the reference's distribution knobs:
``remat`` (what a train step keeps of each body period's activations,
``models.transformer._remat``) and ``fsdp_gather`` (the unshard-at-use
hint of a sharded step, ``models.act_sharding.unshard_fsdp``).

``pattern`` is the periodic block unit scanned over depth; block kinds:
  dense  — GQA self-attention (+optional sliding window) + MLP
  moe    — GQA self-attention (+optional window) + MoE FFN
  local  — local (windowed) attention + MLP (recurrentgemma)
  rglru  — RG-LRU recurrent block + MLP
  mlstm / slstm — xLSTM blocks (no separate MLP; d_ff = 0)
  cross  — cross-attention over stub image embeddings + MLP (vlm)
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # DeepSeek shared experts (always active)
    first_dense: int = 0         # leading layers with plain MLP
    capacity_factor: float = 1.25
    d_ff: int = 0                # per-expert hidden (fine-grained for DS)
    dispatch_groups: int = 1     # >1: group-local dispatch: tokens route
    #                              within groups, each with its own capacity


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("dense",)
    window: int | None = None          # sliding window for attention blocks
    local_window: int | None = None    # window for 'local' blocks
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    head_dim: int | None = None
    embed_inputs: bool = True          # False: frontend stub feeds embeddings
    n_img_tokens: int = 0              # vlm stub: image patch embeddings
    act: str = "swiglu"
    dtype: str = "bfloat16"
    # distribution knobs
    remat: str = "full"                # full | dots | none
    sublinear_attention: bool = False  # True iff long_500k is runnable
    kv_dtype: str | None = None        # "int8": quantized KV cache
    fsdp_gather: bool = False          # unshard-at-use hint per period
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke-test scale (CPU-runnable)."""
        period = len(self.pattern)
        nl = period * 2 if self.moe is None else max(period * 2, 2)
        nl = max(nl, (self.moe.first_dense + period) if self.moe else nl)
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                          top_k=min(self.moe.top_k, 2), d_ff=64)
        return replace(
            self, n_layers=nl, d_model=64,
            n_heads=4, n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            d_ff=0 if self.d_ff == 0 else 128, vocab=256, moe=moe,
            window=min(self.window, 16) if self.window else None,
            local_window=min(self.local_window, 16) if self.local_window else None,
            head_dim=16, n_img_tokens=min(self.n_img_tokens, 8),
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape == "long_500k":
        return cfg.sublinear_attention
    return True
