"""Batched serving, the port of ``repro.launch.serve``: left-padded
prompts, one prefill per batch (attention on K8, the RG-LRU scan on K9),
then greedy decode.

The decode loop's MoE edges go through the serving dataplane: each
step's top-k expert routing becomes an alltoallv dispatch and a
reduce_scatterv combine planned through
:class:`~repro_torch.tuner.serving.ServingPlanner` (``--experts``, 4 by
default as in the reference; 0 turns it off), so raw per-step size
vectors collapse onto padded signature classes and the steady-state loop
plans nothing new.  Per-step spans feed the ``repro_torch.obs`` trace
plane (run under ``REPRO_TORCH_TRACE=1``, or export with ``--trace-out``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --reduced --device cpu --requests 8 \\
        --prompt-len 24 --gen 16 --experts 4

Differences from the reference: the loop is :func:`serve_requests`,
which returns the generated tokens and the timings; ``--device`` and
``--seed`` choose the device and the seed of the weights and prompts;
``--trace-replay`` reads the port's own copy of the seeded diurnal trace
(``launch.serve_trace``).
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
from ..tuner import PlannerService, ServingPlanner
from .serve_trace import serve_trace


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
    leaving shard i.
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
                   device=None, serving: ServingPlanner | None = None,
                   experts: int = 4, top_k: int = 2) -> dict:
    """Serve the prompts of ``queue`` (int token arrays, any lengths) in
    batches of ``batch``: left-pad each batch to its longest prompt,
    prefill it into a fresh cache of ``plen + gen`` positions, then run
    ``gen`` greedy decode steps.

    Returns ``tokens`` (per request, in queue order, the ``gen + 1``
    greedy tokens: the prefill's and each decode step's), ``prefill_s``
    and ``decode_s`` (per batch, the prefill and the whole decode loop,
    each ending in a device sync), ``tokens_out`` (``gen`` per request, as
    the reference counts) and ``wall_s``.

    Without ``serving`` decode makes no host sync until its batch is
    done.  With a :class:`~repro_torch.tuner.serving.ServingPlanner`, each
    decode step routes its tokens over ``experts`` virtual shards, top
    ``top_k`` (:func:`route_step`), and plans the step's alltoallv
    dispatch and reduce_scatterv combine at ``d_model * 4``-byte rows,
    then prefetches the predicted next classes, as the reference's loop
    does.  Routing reads the step's tokens on the host: one
    device-to-host copy of ``batch`` ints a step, which waits for the
    step.  Planning changes no token."""
    device = resolve_device(device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    queue = list(queue)
    out: list[np.ndarray] = []
    prefill_s, decode_s = [], []
    tokens_out = step_id = 0
    row_bytes = cfg.d_model * 4
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
            if serving is not None:
                S, n = route_step(cur.cpu().numpy(), experts, top_k, step_id)
                serving.plan_step("alltoallv", S, row_bytes=row_bytes)
                serving.plan_step("reduce_scatterv", [int(v) for v in n],
                                  row_bytes=row_bytes)
                serving.prefetch()     # off the hot path: next classes
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


def _queue(args, cfg, rng) -> list:
    """The request queue: ragged prompt lengths (the irregular scatter
    pattern), from the diurnal trace's admissions with ``--trace-replay``
    (clamped to the demo's prompt cap) or drawn from ``rng``."""
    if not args.trace_replay:
        return [rng.integers(
            0, cfg.vocab,
            rng.integers(args.prompt_len // 2, args.prompt_len + 1)).astype(
                np.int32) for _ in range(args.requests)]
    plens: list[int] = []
    for step in serve_trace(max(2, args.experts or 4), steps=64, seed=0,
                            base_qps=max(1.0, args.requests / 8),
                            prompt_len_range=(max(1, args.prompt_len // 2),
                                              args.prompt_len)):
        plens.extend(int(x) for x in step["prompt_lens"])
        if len(plens) >= args.requests:
            break
    if not plens:
        plens = [args.prompt_len]
    plens = plens * (1 + args.requests // len(plens))
    return [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in plens[: args.requests]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--experts", type=int, default=4,
                    help="virtual MoE shard/expert count for the "
                         "dispatch/combine planning (0 = off)")
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--class-bound", type=float, default=0.25,
                    help="signature-class padding overhead bound")
    ap.add_argument("--trace-replay", action="store_true",
                    help="draw request arrivals from the seeded diurnal "
                         "trace (launch.serve_trace)")
    ap.add_argument("--trace-out", default=None,
                    help="write the obs trace (Chrome-trace JSON) here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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

    recorder = None
    if args.trace_out is not None and obs_trace.current() is None:
        recorder = obs_trace.enable(obs_trace.TraceRecorder())
    queue = _queue(args, cfg, rng)
    serving = None
    if args.experts > 0:
        svc = PlannerService(mesh=None, quantum=1)
        serving = ServingPlanner(svc, max_overhead=args.class_bound,
                                 row_bytes=cfg.d_model * 4)
    res = serve_requests(params, cfg, queue, args.batch, args.gen, device,
                         serving=serving, experts=args.experts,
                         top_k=args.top_k)
    print(f"served {len(res['tokens'])} requests, {res['tokens_out']} "
          f"tokens, {res['tokens_out'] / res['wall_s']:.1f} tok/s on "
          f"{device}")
    if serving is not None:
        st = serving.stats()
        print(f"planner: {st['classes']} signature classes over "
              f"{st['steps']} plan steps, {st['plan_hits']} hits / "
              f"{st['plan_misses']} misses, {st['compiles']} compiles, "
              f"prefetch {st['prefetch_hits']}/{st['prefetch_planned']}, "
              f"padding overhead <= {st['overhead_max']:.3f} "
              f"(bound {st['overhead_bound']})")
    if recorder is not None:
        path = recorder.save(args.trace_out)
        obs_trace.disable()
        print(f"trace written to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
