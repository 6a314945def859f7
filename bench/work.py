"""The yardstick's arithmetic: the model FLOPs of served tokens, K8's
operations, K6's bytes, and the card's published peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
"""
from __future__ import annotations

from .reference import kinds
from .reference.spec import ModelSpec

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2
INDEX_BYTES = 4            # K6's int32 row indices


def active_params(spec: ModelSpec) -> int:
    """The non-embedding parameters one token uses: every layer's block
    kinds' (``kind.params``; in an MoE layer the router, ``top_k`` routed
    experts and the shared experts)."""
    return sum(kind.params(spec) for layer in kinds.of_layers(spec)
               for kind in layer)


def attention_flops(spec: ModelSpec, pairs: int) -> int:
    """``pairs`` (query, key) pairs in every layer, at each of its kinds'
    FLOPs a pair."""
    return sum(kind.pair_flops(spec) * pairs
               for layer in kinds.of_layers(spec) for kind in layer)


def visible_flops(spec: ModelSpec, n: int) -> int:
    """The attention's FLOPs over one sequence of ``n`` tokens: each
    layer's kinds' FLOPs a pair times their visible pairs (``kind.pairs``,
    causal where a kind gives none)."""
    return sum(kind.pair_flops(spec)
               * getattr(kind, "pairs", lambda _, m: causal_pairs(m))(
                   spec, n)
               for layer in kinds.of_layers(spec) for kind in layer)


def unembed_flops(spec: ModelSpec, rows: int) -> int:
    return 2 * spec.d_model * spec.vocab * rows


def causal_pairs(n: int) -> int:
    """The (query, key) pairs of causal attention over ``n`` tokens."""
    return n * (n + 1) // 2


def request_flops(spec: ModelSpec, prompt: int, steps: int) -> int:
    """Model FLOPs of one request as the user sees it: its ``prompt``
    tokens and the ``steps`` served tokens fed back, unpadded; the
    attention over its own tokens; the unembedding of the ``steps + 1``
    positions that give a token."""
    n = prompt + steps
    return (2 * active_params(spec) * n + visible_flops(spec, n)
            + unembed_flops(spec, steps + 1))


def k8_flops(spec: ModelSpec, batch: int, t: int) -> int:
    """K8's work in one prefill of ``batch`` rows padded to ``t``: the
    attention at every layer."""
    return batch * visible_flops(spec, t)


def k8_bytes(spec: ModelSpec, batch: int, t: int) -> int:
    """q, k, v read once and the output written once, every layer
    (``kind.attn_bytes``)."""
    return sum(kind.attn_bytes(spec, batch * t)
               for layer in kinds.of_layers(spec) for kind in layer
               if hasattr(kind, "attn_bytes"))


def _gather_bytes(rows_out: int, rows_in: int, d: int) -> int:
    """A gather of ``rows_out`` rows of ``d`` bf16 values: each output row
    written once, each of at most ``rows_in`` distinct source rows read
    once, one index a row."""
    return (rows_out * d * BF16_BYTES + min(rows_out, rows_in) * d
            * BF16_BYTES + rows_out * INDEX_BYTES)


def k6_bytes(spec: ModelSpec, tokens: int) -> int:
    """K6's bytes in the MoE layers of one call over a dispatch group of
    ``tokens``: the dispatch gathers the ``E * C`` buffer rows from the
    ``tokens + 1`` rows (a zero row for empty slots), the combine gathers
    each of the ``tokens * top_k`` pairs' rows from the ``E * C``."""
    if not spec.moe:
        return 0
    ec = spec.n_experts * spec.capacity(tokens)
    pairs = tokens * spec.top_k
    per_layer = (_gather_bytes(ec, tokens + 1, spec.d_model)
                 + _gather_bytes(pairs, ec, spec.d_model))
    return per_layer * spec.kinds().count("moe")


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take over ``seconds``, in %."""
    least = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * least / seconds
