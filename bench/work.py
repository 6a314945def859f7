"""The yardstick's arithmetic: the model FLOPs of served tokens, K8's
operations, K6's bytes, and the card's published peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
"""
from __future__ import annotations

from .reference.spec import ModelSpec

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2
INDEX_BYTES = 4            # K6's int32 row indices


def attention_params(spec: ModelSpec) -> int:
    d, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def active_params(spec: ModelSpec) -> int:
    """The non-embedding parameters one token uses: every layer's
    attention, the dense layers' MLPs, and in an MoE layer the router,
    ``top_k`` routed experts and the shared experts."""
    d = spec.d_model
    total = 0
    for kind in spec.kinds():
        total += attention_params(spec)
        if kind == "dense":
            total += 3 * d * spec.d_ff
        else:
            total += d * spec.n_experts + 3 * d * spec.expert_d_ff * (
                spec.top_k + spec.n_shared)
    return total


def attention_flops(spec: ModelSpec, pairs: int) -> int:
    """Two products over ``pairs`` (query, key) pairs in every layer."""
    return 4 * spec.head_dim * spec.n_heads * pairs * spec.n_layers


def unembed_flops(spec: ModelSpec, rows: int) -> int:
    return 2 * spec.d_model * spec.vocab * rows


def causal_pairs(n: int) -> int:
    """The (query, key) pairs of causal attention over ``n`` tokens."""
    return n * (n + 1) // 2


def request_flops(spec: ModelSpec, prompt: int, steps: int) -> int:
    """Model FLOPs of one request as the user sees it: its ``prompt``
    tokens and the ``steps`` served tokens fed back, unpadded; causal
    attention over its own tokens; the unembedding of the ``steps + 1``
    positions that give a token."""
    n = prompt + steps
    return (2 * active_params(spec) * n
            + attention_flops(spec, causal_pairs(n))
            + unembed_flops(spec, steps + 1))


def k8_flops(spec: ModelSpec, batch: int, t: int) -> int:
    """K8's work in one prefill of ``batch`` rows padded to ``t``: causal
    attention at every layer."""
    return attention_flops(spec, batch * causal_pairs(t))


def k8_bytes(spec: ModelSpec, batch: int, t: int) -> int:
    """q, k, v read once and the output written once, every layer."""
    H, Hkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    return (batch * t * (2 * H + 2 * Hkv) * hd * BF16_BYTES
            * spec.n_layers)


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
    return per_layer * (spec.n_layers - spec.first_dense)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take over ``seconds``, in %."""
    least = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * least / seconds
