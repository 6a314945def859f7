"""Block kinds: one module each, ``bench/reference/kinds/<kind>.py``,
found by name.  A configuration file names the kinds of each of its
layer types under ``blocks`` (``{"dense": ["gqa", "swiglu"], "moe":
["gqa", "deepseek_moe"]}``); a layer applies its kinds in that order,
each to the RMSNorm of the residual stream (kind ``i`` reads the gain
``norm<i + 1>`` of the layer's weights) and adds what it returns.

A kind module gives:

* ``SLOT``: the key of its weights in a layer's weights (``attn``,
  ``ffn``), as the program lays them out;
* ``shapes(spec)``: its drawn weights, ``{path: (shape, fan_in, fp32)}``
  under ``SLOT``, in the order they are drawn;
* ``forward(p, h, spec, ctx, mm)``: the plain float32 forward of the
  normed input ``h`` ``(B, T, D)``, with ``p`` its weights, ``ctx`` the
  batch's :class:`~bench.reference.model.Context` and ``mm`` every
  product with a weight;
* ``params(spec)``: the parameters one token uses;
* ``pair_flops(spec)``: the FLOPs a visible (query, key) pair costs in
  one layer, 0 for a kind that attends to nothing;

and where it attends, optionally ``pairs(spec, n)`` (the visible pairs
of a sequence of ``n`` tokens; causal by default) and
``attn_bytes(spec, tokens)`` (the attention's q, k, v read and output
written once over ``tokens`` tokens, in bf16; 0 by default).
"""
from __future__ import annotations

import importlib
import re
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name: str) -> ModuleType:
    """The kind module ``name``."""
    if not _NAME.match(name):
        raise ValueError(f"no block kind {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def of_layers(spec) -> list[list[ModuleType]]:
    """Each layer's kind modules in order, by its layer type
    (``spec.kinds()``) and the file's ``blocks``."""
    blocks = spec.raw.get("blocks")
    if blocks is None:
        raise KeyError(f"{spec.name}: the configuration names no block "
                       f"kinds (key 'blocks')")
    by_type = {}
    for t in set(spec.kinds()):
        if t not in blocks:
            raise KeyError(f"{spec.name}: 'blocks' names no kinds for the "
                           f"layer type {t!r}")
        by_type[t] = [load(k) for k in blocks[t]]
    return [by_type[t] for t in spec.kinds()]
