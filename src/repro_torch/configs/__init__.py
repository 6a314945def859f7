"""Config registry of the port: ``get_config("yi-6b")`` resolves every
architecture of ``repro.configs``, copied from it in its order, with its
analytic parameter counts and benchmark shapes."""
from __future__ import annotations

import importlib

from .base import (SHAPES, ArchConfig, MoEConfig, ShapeConfig,  # noqa: F401
                   shape_applicable)

_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "musicgen-large": "musicgen_large",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "llama3-405b": "llama3_405b",
    "stablelm-3b": "stablelm_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, H, Hk = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    n_attn = d * H * hd + 2 * d * Hk * hd + H * hd * d
    n_mlp = 3 * d * ff if cfg.act == "swiglu" else 2 * d * ff
    total = V * d  # embedding (tied head)
    first = cfg.moe.first_dense if cfg.moe else 0
    for i in range(cfg.n_layers):
        kind = ("dense" if i < first
                else cfg.pattern[(i - first) % len(cfg.pattern)])
        if kind == "dense":
            ffw = n_mlp if ff else 3 * d * (4 * d)
            total += n_attn + ffw
        elif kind == "moe":
            E, F = cfg.moe.n_experts, cfg.moe.d_ff
            total += n_attn + E * 3 * d * F + d * E
            if cfg.moe.n_shared:
                total += 3 * d * F * cfg.moe.n_shared
        elif kind == "cross":
            total += 2 * n_attn + n_mlp
        elif kind == "local":
            total += n_attn + n_mlp
        elif kind == "rglru":
            total += 6 * d * d + n_mlp  # wx,wg,wo,wa,wi + conv/lam ~ small
        elif kind == "mlstm":
            total += 5 * d * d + 2 * d * H
        elif kind == "slstm":
            total += 4 * d * d + 4 * d * d // H + d * d
    return int(total)


def active_param_count(cfg: ArchConfig) -> int:
    """MoE: only top-k (+shared) experts are active per token (6*N_active*D)."""
    if cfg.moe is None:
        return param_count(cfg)
    full = param_count(cfg)
    E, K, F, d = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff,
                  cfg.d_model)
    first = cfg.moe.first_dense
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers)
        if i >= first and cfg.pattern[(i - first) % len(cfg.pattern)] == "moe")
    inactive = n_moe_layers * (E - K) * 3 * d * F
    return int(full - inactive)
