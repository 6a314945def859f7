"""Batched serving, the port of ``repro.launch.serve``: left-padded
prompts, one prefill per batch (attention on K8, the RG-LRU scan on K9),
then greedy decode, on a CUDA device one replayed CUDA graph a step
(:func:`serve_requests`).

The decode loop's MoE edges go through the serving dataplane: each
step's top-k expert routing becomes an alltoallv dispatch and a
reduce_scatterv combine planned through
:class:`~repro_torch.tuner.serving.ServingPlanner` (``--experts``, 4 by
default as in the reference; 0 turns it off), so raw per-step size
vectors collapse onto padded signature classes and the steady-state loop
plans nothing new.

Tracing (``repro_torch.obs.trace``; on under ``REPRO_TORCH_TRACE=1``, or
for one run with ``--trace-out``, which writes the Chrome-trace JSON)
records a span tree a batch, and nothing when off (while it records, the
decode loop runs eagerly, launch by launch):

* ``serve/batch`` (args ``batch``, its index in the call, ``B``,
  ``plen`` and ``requests``, its requests' queue indices): the root whose
  id every span of the batch descends from;
* ``serve/prefill``: the prefill call up to its device sync;
* ``serve/decode_step`` (arg ``step``): the host's enqueue of one decode
  step, up to its greedy token, with no sync: the host's time, not the
  device's;
* under those, ``model/attention`` and ``model/moe`` a block
  (``models/transformer.py``), and under ``model/moe`` the spans
  ``moe/route``, ``moe/dispatch``, ``moe/experts``, ``moe/combine`` (and
  a second ``moe/experts``, the shared MLP, where there is one) and the
  counts ``moe_pairs_routed`` and ``moe_pairs_dropped``
  (``models/moe.py``), whose device values are read once, after the
  batch's served tokens;
* with the planner on, its ``serve/plan_step`` and ``serve/prefetch``
  spans (``tuner/serving.py``) and the ``plan/<op>`` span of each plan it
  builds, between the decode steps.

While ``torch.profiler`` records, each span is also a ``record_function``
range, so a profile holds the program's spans around the kernels they
launch.

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
from ..core.dtensor import is_dtensor
from ..core.mesh import resolve_device
from ..core.tree import tree_leaves
from ..models.transformer import init_cache, init_params
from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY as _OBS_REGISTRY
from ..train.steps import make_decode_step, make_prefill_step
from ..tuner import PlannerService, ServingPlanner
from ..tuner.service import end_failed_capture
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


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of each row, ``(B, 1)`` int32."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def _copy_replaced(static: dict, new: dict) -> None:
    """Copy into each leaf of ``static`` the leaf of ``new`` that a step
    put in its place (``pos``, the recurrent states); a leaf the step
    updated in place is the same tensor in both."""
    for s, n in zip(tree_leaves(static), tree_leaves(new), strict=True):
        if n is s:
            continue
        if n.shape != s.shape or n.dtype != s.dtype:
            raise ValueError(f"a decode step changed a cache leaf from "
                             f"{s.dtype} {tuple(s.shape)} to {n.dtype} "
                             f"{tuple(n.shape)}: a graph cannot replay it")
        s.copy_(n)


def _weights_key(params: dict, make_decode) -> tuple | None:
    """What a graph of a step of ``make_decode`` depends on besides the
    config and the batch shape: the step builder and each weight leaf's
    data pointer, shape, strides and dtype; None where a leaf is a
    DTensor."""
    leaves = []
    for t in tree_leaves(params):
        if is_dtensor(t):
            return None
        leaves.append((t.data_ptr(), t.shape, t.stride(), t.dtype))
    return make_decode, tuple(leaves)


class _DecodeGraph:
    """One batch shape's decode step as a CUDA graph on one device, and the
    buffers it reads and writes (:func:`serve_requests`).

    ``key`` is the config, ``B`` and ``plen + gen``; ``cache`` is
    ``init_cache``'s cache of that shape, handed to every prefill of the
    shape; the leaves the steps update in place (the attention caches,
    which ``init_cache`` makes zero) are zeroed before each prefill but
    the first.  ``static`` is the cache tree the graph reads, the first
    prefill's output; each later prefill's output and each step copy into
    it the leaves they replace (``_copy_replaced``).  ``tok`` holds the
    step's input token, and the next token after it.  ``graph`` was
    captured with the weights of ``wkey`` (:func:`_weights_key`)."""

    def __init__(self, key: tuple, cache: dict):
        self.key, self.cache = key, cache
        self.static = self.tok = self.graph = self.wkey = None
        self.inplace: list[torch.Tensor] = []

    def prefill_cache(self) -> dict:
        for t in self.inplace:
            t.zero_()
        return self.cache

    def start(self, cache: dict, cur: torch.Tensor, wkey: tuple) -> None:
        """Take a prefill's output ``cache`` and token ``cur``; the next
        step captures anew unless the graph has the weights of ``wkey``."""
        if wkey != self.wkey:
            self.graph, self.wkey = None, wkey
        if self.static is None:
            self.static, self.tok = cache, cur.clone()
            held = {id(t) for t in tree_leaves(cache)}
            self.inplace = [t for t in tree_leaves(self.cache)
                            if id(t) in held]
        else:
            _copy_replaced(self.static, cache)
            self.tok.copy_(cur)

    def _step(self, decode, params: dict) -> None:
        logits, new = decode(params, self.static, {"tokens": self.tok})
        cur = _greedy(logits)
        _copy_replaced(self.static, new)
        self.tok.copy_(cur)

    def step(self, decode, params: dict, device: torch.device
             ) -> torch.Tensor:
        """One decode step: a replay, or, before the first, the step run
        eagerly on a side stream (the capture's warm-up), then captured
        there.  Returns a copy of the step's token."""
        with torch.cuda.device(device):
            if self.graph is not None:
                self.graph.replay()
                _OBS_REGISTRY.counter("decode_graph_replays").inc()
                return self.tok.clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            graph = torch.cuda.CUDAGraph()
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(side):
                self._step(decode, params)
                _OBS_REGISTRY.counter("decode_eager_steps").inc()
                graph.capture_begin(pool=pool)
                try:
                    self._step(decode, params)
                except BaseException:
                    end_failed_capture(device, graph, pool)
                    raise
                graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = graph
            _OBS_REGISTRY.counter("decode_graph_captures").inc()
            return self.tok.clone()


# the decode graph of each CUDA device: one batch shape, one cache, as an
# eager batch holds one cache
_GRAPHS: dict[torch.device, _DecodeGraph] = {}


def _decode_graph(device: torch.device, cfg, batch: int,
                  seq_len: int) -> _DecodeGraph:
    """``device``'s entry if it has this config and shape; else the old
    entry is let go first and a new one made with ``init_cache``'s
    cache."""
    key = (cfg, batch, seq_len)
    entry = _GRAPHS.get(device)
    if entry is not None and entry.key == key:
        return entry
    _GRAPHS.pop(device, None)
    entry = _GRAPHS[device] = _DecodeGraph(
        key, init_cache(cfg, batch, seq_len, device))
    return entry


def serve_requests(params: dict, cfg, queue: list, batch: int, gen: int,
                   device=None, serving: ServingPlanner | None = None,
                   experts: int = 4, top_k: int = 2) -> dict:
    """Serve the prompts of ``queue`` (int token arrays, any lengths) in
    batches of ``batch``: left-pad each batch to its longest prompt,
    prefill it into a zero cache of ``plen + gen`` positions, then run
    ``gen`` greedy decode steps.

    Returns ``tokens`` (per request, in queue order, the ``gen + 1``
    greedy tokens: the prefill's and each decode step's), ``prefill_s``
    and ``decode_s`` (per batch, the prefill and the whole decode loop,
    each ending in a device sync), ``tokens_out`` (``gen`` per request, as
    the reference counts) and ``wall_s``.

    On a CUDA device the decode loop replays one CUDA graph of the step
    (``make_decode_step``'s, with its greedy token).  One entry a device,
    kept across calls, holds the cache of the last batch shape (the
    config, ``B`` and ``plen + gen``) and the graph, captured under a key
    of the step builder and the weights' data pointers, shapes, strides
    and dtypes, taken once a call after the first prefill (outside the
    time to the first token).  A batch of the entry's shape prefills into
    its cache (zeroed in place, as ``init_cache`` makes it) in place of a
    fresh one; a batch of another shape lets the entry go and makes a new
    one; other weights keep the cache and capture anew.  A capture runs
    the batch's first step eagerly on a side stream, then captures the
    next into a pool of its own with ``capture_begin`` / ``capture_end``
    (not ``torch.cuda.graph``, whose entry synchronises and empties the
    allocator's cache); every later step replays, with no allocation and
    no host sync.  Nothing of it runs inside the prefill's timer.  The
    loop stays eager on the CPU, when a weight is a DTensor (the first
    prefill has the entry's plain cache, as ``init_cache`` would give),
    and while ``obs.trace`` records (the per-layer spans and the MoE
    counts are taken on the host at each launch).
    ``obs.metrics.REGISTRY`` counts ``decode_graph_captures``,
    ``decode_graph_replays`` and ``decode_eager_steps`` (one a step; the
    warm-up step is eager).  ``kernels.backend.LAUNCHES`` counts a
    graphed step's kernels once, at its capture, and not at each
    replay.

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
    graphed = device.type == "cuda" and obs_trace.current() is None
    wkey = None
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
        with obs_trace.span("serve/batch", "serving", batch=len(prefill_s),
                            B=b, plen=plen,
                            requests=list(range(len(out), len(out) + b))):
            toks = np.zeros((b, plen), np.int32)
            for i, p in enumerate(prompts):
                toks[i, plen - len(p):] = p   # left-pad (simple alignment)
            graph = None
            if graphed:
                graph = _decode_graph(device, cfg, b, plen + gen)
                cache = graph.prefill_cache()
            else:
                cache = init_cache(cfg, b, plen + gen, device)
            t_pre = time.perf_counter()
            with obs_trace.span("serve/prefill", "serving"):
                logits, cache = prefill(
                    params, {"tokens": torch.from_numpy(toks).to(device)},
                    cache)
                cur = _greedy(logits)
                _sync(device)
            t_dec = time.perf_counter()
            prefill_s.append(t_dec - t_pre)
            if graph is not None:
                wkey = wkey or _weights_key(params, make_decode_step)
                if wkey is None:
                    _GRAPHS.pop(device)
                    graphed, graph = False, None
                else:
                    graph.start(cache, cur, wkey)
            picked = [cur]
            for _ in range(gen):
                with obs_trace.span("serve/decode_step", "serving",
                                    step=step_id):
                    if graph is not None:
                        cur = graph.step(decode, params, device)
                    else:
                        logits, cache = decode(params, cache,
                                               {"tokens": cur})
                        cur = _greedy(logits)
                        _OBS_REGISTRY.counter("decode_eager_steps").inc()
                picked.append(cur)
                if serving is not None:
                    S, n = route_step(cur.cpu().numpy(), experts, top_k,
                                      step_id)
                    serving.plan_step("alltoallv", S, row_bytes=row_bytes)
                    serving.plan_step("reduce_scatterv", [int(v) for v in n],
                                      row_bytes=row_bytes)
                    serving.prefetch()     # off the hot path: next classes
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
