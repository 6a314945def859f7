"""The weights of a cell, made from ``--seed`` on the device and handed to
both the program and the reference.

The layout is the one the program's ``init_params`` gives: ``embed`` /
``e`` ``(V, D)``, ``final_norm`` / ``g``, and the layers as ``first``
(DeepSeek's dense first layer), ``body`` (one list per period of the
layer pattern) and ``tail``; each layer holds, for its ``i``-th block
kind (``reference/kinds/``), the norm gain ``norm<i + 1>`` and the
kind's weights under its ``SLOT``, as the kind's ``shapes`` gives them
(GQA's ``attn``: ``wq``, ``wk``, ``wv``, ``wo``; an MLP's or the MoE
layer's ``ffn``).

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

from .reference import kinds as block_kinds
from .reference.spec import ModelSpec

ALIGN = 256          # elements: 512 bytes of bf16


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
    layer_kinds = block_kinds.of_layers(spec)
    for i, layer in enumerate(layer_kinds):
        for kind in layer:
            for path, (shape, fan_in, fp32) in kind.shapes(spec).items():
                leaves.append((("layer", i, kind.SLOT) + path, shape, fan_in,
                               fp32))
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
    layers = [{f"norm{j + 1}": {"g": torch.ones(spec.d_model, dtype=dtype,
                                                device=device)}
               for j in range(len(layer))}
              for layer in layer_kinds]
    for (path, shape, fan_in, fp32), off in zip(leaves, offsets):
        t = flat[fp32][off: off + math.prod(shape)].view(shape)
        t.mul_(1.0 / math.sqrt(fan_in))
        if path[0] == "layer":
            _put(layers[path[1]], path[2:], t)
        else:
            _put(tree, path, t)
    # grouped as the program's layer plan: the leading dense layers, the
    # body's periods, the tail
    n_first = spec.first_dense if spec.moe else 0
    period = len(spec.pattern)
    n_body = (spec.n_layers - n_first) // period * period
    tree["first"] = layers[:n_first]
    tree["body"] = [layers[i: i + period]
                    for i in range(n_first, n_first + n_body, period)]
    tree["tail"] = layers[n_first + n_body:]
    return tree
