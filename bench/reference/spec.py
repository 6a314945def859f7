"""A configuration file of ``bench/configs/`` read as the sizes the
reference, the weight maker and the work formulas need; ``raw`` keeps
the whole file, so that a block kind (``kinds/``) can read keys of its
own, such as ``sliding_window``."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None       # None where the file gives none
    d_ff: int                  # the dense layers' SwiGLU width
    vocab: int
    rope_theta: float
    eps: float
    n_experts: int = 0         # 0: a dense model
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared: int = 0
    first_dense: int = 0
    capacity_factor: float = 0.0
    raw: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def pattern(self) -> tuple[str, ...]:
        """The layer types of one period after the leading dense layers:
        the program's ``pattern`` where the file's ``program`` gives one,
        else ``moe`` or ``dense``."""
        given = self.raw.get("program", {}).get("pattern")
        if given:
            return tuple(given)
        return ("moe",) if self.moe else ("dense",)

    def kinds(self) -> list[str]:
        """Each layer's type in order: ``first_dense`` leading ``dense``
        layers in an MoE model, then the periods of :attr:`pattern`."""
        first = ["dense"] * (self.first_dense if self.moe else 0)
        period = self.pattern
        return first + [period[i % len(period)]
                        for i in range(self.n_layers - len(first))]

    def capacity(self, tokens: int) -> int:
        """Rows of each expert's buffer for a dispatch group of
        ``tokens``: ``int(factor * tokens * top_k / experts) + 1``."""
        return int(self.capacity_factor * tokens * self.top_k
                   / self.n_experts) + 1


def from_dict(c: dict) -> ModelSpec:
    """The sizes of a configuration file's dict (Hugging Face key names)."""
    moe = "n_routed_experts" in c
    return ModelSpec(
        name=c["name"], n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c.get("head_dim"),
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        n_experts=c.get("n_routed_experts", 0),
        top_k=c.get("num_experts_per_tok", 0),
        expert_d_ff=c.get("moe_intermediate_size", 0),
        n_shared=c.get("n_shared_experts", 0),
        first_dense=c.get("first_k_dense_replace", 0),
        capacity_factor=float(c.get("capacity_factor", 0.0)) if moe else 0.0,
        raw=c)


def load(path: str | Path) -> ModelSpec:
    return from_dict(json.loads(Path(path).read_text()))
