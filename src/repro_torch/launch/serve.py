"""Batched serving, the port of ``repro.launch.serve``: left-padded
prompts, one prefill per batch (attention on K8, the RG-LRU scan on K9),
then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --reduced --device cpu --requests 8 \\
        --prompt-len 24 --gen 16

Differences from the reference: the loop is
:func:`serve_requests`, which returns the generated tokens and the
timings; the ServingPlanner hook (``--experts > 0``) and
``--trace-replay`` need the tuner and the serving planner (ROADMAP items
7–8), so ``--experts`` defaults to 0 and any other value raises, as does
``--trace-replay`` (and ``--top-k``, which only the planner reads, is
left out); decode-step spans go to an active
``repro_torch.obs.trace`` recorder (``TraceRecorder.save`` writes its
Chrome trace); ``--trace-out`` waits for the serving planner.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.mesh import resolve_device
from ..models.transformer import init_cache, init_params
from ..obs import trace as obs_trace
from ..train.steps import make_decode_step, make_prefill_step


def pop_batch(queue: list, batch: int) -> list:
    """Drain up to ``batch`` requests off the queue head (never more than
    ``len(queue)``)."""
    take = min(int(batch), len(queue))
    return [queue.pop(0) for _ in range(take)]


def route_step(tokens: np.ndarray, experts: int, top_k: int,
               step: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic per-step top-k routing of the current batch tokens.

    Batch slot ``b`` lives on shard ``b % experts``; its ``top_k``
    experts are a hash of (token id, step, slot), so the dispatch matrix
    churns every decode step as a learned router's output does.  Returns
    ``(S, n)``: ``S[i][j]`` rows shard i sends expert j, ``n[i]`` rows
    leaving shard i.  (The size vectors the serving planner of ROADMAP
    item 8 will plan from.)
    """
    p = int(experts)
    S = np.zeros((p, p), np.int64)
    for b, tok in enumerate(np.asarray(tokens).reshape(-1)):
        shard = b % p
        h = (int(tok) * 2654435761 + step * 97 + b) % (1 << 32)
        first = h % p
        for k in range(top_k):
            S[shard, (first + k * max(1, h % (p - 1) if p > 1 else 1)) % p] \
                += 1
    return S, S.sum(axis=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_requests(params: dict, cfg, queue: list, batch: int, gen: int,
                   device=None) -> dict:
    """Serve the prompts of ``queue`` (int token arrays, any lengths) in
    batches of ``batch``: left-pad each batch to its longest prompt,
    prefill it into a fresh cache of ``plen + gen`` positions, then run
    ``gen`` greedy decode steps.

    Returns ``tokens`` (per request, in queue order, the ``gen + 1``
    greedy tokens: the prefill's and each decode step's), ``prefill_s``
    and ``decode_s`` (per batch, the prefill and the whole decode loop,
    each ending in a device sync), ``tokens_out`` (``gen`` per request, as
    the reference counts) and ``wall_s``.  Decode makes no host sync
    until its batch is done."""
    device = resolve_device(device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    queue = list(queue)
    out: list[np.ndarray] = []
    prefill_s, decode_s = [], []
    tokens_out = step_id = 0
    _sync(device)
    t0 = time.perf_counter()
    while queue:
        prompts = pop_batch(queue, batch)
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p   # left-pad (simple alignment)
        cache = init_cache(cfg, b, plen + gen, device)
        t_pre = time.perf_counter()
        logits, cache = prefill(
            params, {"tokens": torch.from_numpy(toks).to(device)}, cache)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        _sync(device)
        t_dec = time.perf_counter()
        prefill_s.append(t_dec - t_pre)
        picked = [cur]
        for _ in range(gen):
            t_step = time.perf_counter()
            logits, cache = decode(params, cache, {"tokens": cur})
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            picked.append(cur)
            tr = obs_trace.current()
            if tr is not None:
                tr.add_complete("serve/decode_step", "serving", t_step,
                                time.perf_counter() - t_step, step=step_id,
                                batch=b)
            tokens_out += b
            step_id += 1
        got = torch.cat(picked, dim=1).cpu().numpy()
        decode_s.append(time.perf_counter() - t_dec)
        out.extend(got[i] for i in range(b))
    return {"tokens": out, "prefill_s": prefill_s, "decode_s": decode_s,
            "tokens_out": tokens_out, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--experts", type=int, default=0,
                    help="virtual MoE shard/expert count for the "
                         "dispatch/combine planning (0 = off; planning is "
                         "ROADMAP item 8)")
    ap.add_argument("--trace-replay", action="store_true",
                    help="prompt lengths from the diurnal serving trace "
                         "(ROADMAP item 8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.experts or args.trace_replay:
        raise NotImplementedError(
            "--experts > 0 and --trace-replay need the tuner's serving "
            "planner and its trace, ROADMAP item 8")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(dtype="float32")
    if not cfg.embed_inputs:
        raise ValueError("serving takes token archs")
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    queue = [rng.integers(
        0, cfg.vocab,
        rng.integers(args.prompt_len // 2, args.prompt_len + 1)).astype(
            np.int32) for _ in range(args.requests)]
    res = serve_requests(params, cfg, queue, args.batch, args.gen, device)
    print(f"served {len(res['tokens'])} requests, {res['tokens_out']} "
          f"tokens, {res['tokens_out'] / res['wall_s']:.1f} tok/s on "
          f"{device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
