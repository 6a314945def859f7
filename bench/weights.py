"""The weights of a cell, made from ``--seed`` on the device and handed to
both the program and the reference.

The layout is the one the program's ``init_params`` gives: ``embed`` /
``e`` ``(V, D)``, ``final_norm`` / ``g``, and the layers as ``first``
(DeepSeek's dense first layer), ``body`` (one list per period, here one
block each) and ``tail``; each block ``norm1``, ``attn`` (``wq``, ``wk``,
``wv``, ``wo``), ``norm2`` and ``ffn`` (an MLP's ``wi``, ``wg``, ``wo``,
or the MoE layer's float32 ``router`` ``(D, E)``, stacked experts ``wi``
/ ``wg`` ``(E, D, F)`` and ``wo`` ``(E, F, D)`` and ``shared``).

Every product's weight is normal with std ``1 / sqrt(fan-in)``, the
embedding too, as the tied output head's weight (fan-in ``D``: a logit
has std about 1); the norm gains are 1.  (With a unit-std embedding the
tied head's logit of the input token would be ``D`` against others of
about ``sqrt(D)``, and a random model would repeat its input token.)
The draws are two calls, one bf16 buffer and one float32 buffer that
every weight is a view of, each view starting on a 512-byte boundary;
each view is then scaled in place.
"""
from __future__ import annotations

import math

import torch

from .reference.spec import ModelSpec

ALIGN = 256          # elements: 512 bytes of bf16


def _block_shapes(spec: ModelSpec, kind: str) -> dict:
    """``{path: (shape, fan_in, fp32)}`` of one block's drawn weights."""
    D, H, Hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    out = {("attn", "wq"): ((D, H * hd), D, False),
           ("attn", "wk"): ((D, Hkv * hd), D, False),
           ("attn", "wv"): ((D, Hkv * hd), D, False),
           ("attn", "wo"): ((H * hd, D), H * hd, False)}
    if kind == "dense":
        F_ = spec.d_ff
        out.update({("ffn", "wi"): ((D, F_), D, False),
                    ("ffn", "wg"): ((D, F_), D, False),
                    ("ffn", "wo"): ((F_, D), F_, False)})
        return out
    E, F_ = spec.n_experts, spec.expert_d_ff
    out.update({("ffn", "router"): ((D, E), D, True),
                ("ffn", "wi"): ((E, D, F_), D, False),
                ("ffn", "wg"): ((E, D, F_), D, False),
                ("ffn", "wo"): ((E, F_, D), F_, False)})
    if spec.n_shared:
        S = F_ * spec.n_shared
        out.update({("ffn", "shared", "wi"): ((D, S), D, False),
                    ("ffn", "shared", "wg"): ((D, S), D, False),
                    ("ffn", "shared", "wo"): ((S, D), S, False)})
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(spec: ModelSpec, seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The weights of ``spec`` from ``seed`` on ``device``, in ``dtype``
    (the router in float32)."""
    device = torch.device(device)
    leaves = [(("embed", "e"), (spec.vocab, spec.d_model), spec.d_model,
               False)]
    kinds = spec.kinds()
    n_first = spec.first_dense if spec.moe else 0
    for i, kind in enumerate(kinds):
        for path, (shape, fan_in, fp32) in _block_shapes(spec, kind).items():
            leaves.append((("layer", i) + path, shape, fan_in, fp32))
    offsets, total = [], {False: 0, True: 0}
    for _, shape, _, fp32 in leaves:
        offsets.append(total[fp32])
        total[fp32] += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = {fp32: torch.empty(total[fp32], dtype=torch.float32 if fp32
                              else dtype, device=device).normal_(
                                  generator=gen)
            for fp32 in (False, True) if total[fp32]}
    tree = {"embed": {}, "final_norm": {
        "g": torch.ones(spec.d_model, dtype=dtype, device=device)}}
    layers = [{"norm1": {"g": torch.ones(spec.d_model, dtype=dtype,
                                         device=device)},
               "norm2": {"g": torch.ones(spec.d_model, dtype=dtype,
                                         device=device)}}
              for _ in kinds]
    for (path, shape, fan_in, fp32), off in zip(leaves, offsets):
        t = flat[fp32][off: off + math.prod(shape)].view(shape)
        t.mul_(1.0 / math.sqrt(fan_in))
        if path[0] == "layer":
            _put(layers[path[1]], path[2:], t)
        else:
            _put(tree, path, t)
    tree["first"] = layers[:n_first]
    tree["body"] = [[b] for b in layers[n_first:]]
    tree["tail"] = []
    return tree
