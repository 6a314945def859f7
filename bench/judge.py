"""The comparison that decides ``correct``: each greedy token the program
served, against the plain reference's logits at the position that
produced it.

With random weights the largest logit changes on rounding, so a served
token is not required to be the reference's best.  Each token's gap is
how far its reference logit lies below the reference's best logit at its
position; a cell compares the widest or the mean gap, or the mean above
the seed's own rounding floor (:func:`stats`), over every token of a
sample of whole served batches (the batch holding the longest prompt, and
others drawn from the seed).  A batch is judged whole because the MoE
layer's capacity cut couples its rows.

The control puts the reference in the program's place at the precision
below the configuration's (fp8 products, ``reference.model.fp8_matmul``)
and reads, at the same positions of the same prompts and served tokens,
the gap of the token the control puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import model as ref


def pick(batches: list, n: int, seed: int) -> list[int]:
    """Indices of ``n`` batches: the one with the longest prompt, then
    others drawn from ``seed``."""
    longest = max(range(len(batches)),
                  key=lambda i: max(map(len, batches[i].prompts)))
    rest = [i for i in range(len(batches)) if i != longest]
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    drawn = rng.permutation(len(rest))[: max(0, n - 1)]
    return [longest] + [rest[j] for j in sorted(drawn)]


def teacher_tokens(prompts: list, served: list, device) -> tuple:
    """``(tokens, plen, served)``: the left-padded prompts followed by the
    served tokens the decode steps were fed, ``(B, plen + steps)``, and
    the served tokens ``(B, steps + 1)``."""
    plen = max(map(len, prompts))
    got = torch.as_tensor(np.stack(served).astype(np.int64), device=device)
    toks = torch.zeros((len(prompts), plen + got.shape[1] - 1),
                       dtype=torch.long, device=device)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p): plen] = torch.as_tensor(p.astype(np.int64))
    toks[:, plen:] = got[:, :-1]
    return toks, plen, got


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best, ``(B, n)``."""
    return (ref_logits.max(-1).values
            - ref_logits.gather(-1, tokens[..., None]).squeeze(-1))


EXCESS = "logit_gap_mean_excess"


def stats(g: torch.Tensor, floor: torch.Tensor | None = None) -> dict:
    """The numbers a cell may compare, of the gaps ``g`` of its sample:
    ``logit_gap_max`` (the widest) and ``logit_gap_mean``; given
    ``floor``, the gaps at the same positions of the tokens that the
    reference at the configuration's own precision puts first
    (``reference.model.bf16_matmul``), also ``logit_gap_mean_excess``,
    the mean above theirs.  Served tokens that pass many near ties read a
    high mean at any precision; the excess leaves that floor out."""
    g = g.double().flatten()
    out = {"logit_gap_max": float(g.max()), "logit_gap_mean": float(g.mean())}
    if floor is not None:
        out[EXCESS] = out["logit_gap_mean"] - float(floor.double().mean())
    return out


def served_gaps(params: dict, spec, prompts: list, served: list, device,
                mms: tuple = ()) -> list[torch.Tensor]:
    """The gaps ``(B, steps + 1)`` of one batch's served tokens, then of
    the tokens the reference puts first at the same positions with each
    product of ``mms`` (such as the fp8 control's)."""
    toks, plen, got = teacher_tokens(prompts, served, device)
    with fp32_products():
        logits = ref.served_logits(params, spec, toks, plen)
        out = [gaps(logits, got)]
        for mm in mms:
            out.append(gaps(logits, ref.served_logits(
                params, spec, toks, plen, mm=mm).argmax(-1)))
    return out


class fp32_products:
    """float32 products without TF32 inside the block."""

    def __enter__(self):
        self._was = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._was
