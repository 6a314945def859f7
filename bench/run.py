"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as one JSON line.

    python3 bench/run.py --workload dsmoe16b.rag --seed 7 --seconds 51 \\
        --trace 0

Set-up (timed from process start): the weights drawn on the card from
the seed (``weights.py``), then the window's shapes once through the
program's step builders, a prefill and two decode steps (this builds or
loads the program's kernels under ``build/kernels/`` of the checkout).
The window: a closed loop of static batches (``traffic.py``), each one
call of the program's
``repro_torch.launch.serve.serve_requests``, started until ``--seconds``
have passed and ended when the last batch ends.  With ``--trace 1``
more batches follow under ``torch.profiler`` (``devtrace.py``): the
cell's ``trace_batches`` with the device's activity alone, which the
readers read, then one with the host's operations too, which only names
the idle gaps of the ``breakdown``.
Then the program's device memory is read, and a sample of the served
batches is judged against the plain reference (``judge.py``).

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by
``bench/metrics/<name>.py``.  The numbers compared are printed as the
last lines of standard error and under ``checks``, the line's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field, fields, replace  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import devtrace, judge, spec, traffic, weights  # noqa: E402
from bench.reference import model as ref  # noqa: E402

T_IMPORTED = time.perf_counter()

# top-level module names that must not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Batch:
    prompts: list
    t_send: float
    t_end: float
    prefill_s: float
    decode_s: float
    tokens: list

    @property
    def plen(self) -> int:
        return max(map(len, self.prompts))

    @property
    def ttft_s(self) -> float:
        """Send to first token: the call's time less its decode loop."""
        return self.t_end - self.t_send - self.decode_s


@dataclass
class Run:
    """What the metric readers read."""
    spec: spec.model_spec.ModelSpec
    mix: traffic.Mix
    setup_s: float
    window_s: float
    batches: list                  # the window's
    traced: list = field(default_factory=list)
    trace: devtrace.DeviceTrace | None = None
    peak_bytes: int = 0


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def program_config(model: dict):
    """The program's ``ArchConfig`` of a configuration file, refused where
    the file asks for what the program cannot run.  The file's
    ``program`` (fields of ``ArchConfig``, a nested ``moe`` of
    ``MoEConfig``'s) is applied over what the sizes give."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    if (model.get("hidden_act") != "silu" or float(model["rms_norm_eps"])
            != 1e-6 or not model.get("tie_word_embeddings")
            or model.get("norm_topk_prob") is False):
        raise ValueError(f"{model['name']}: the program runs SwiGLU, "
                         f"RMSNorm at 1e-6, a tied head and top-k gates")
    moe = None
    if "n_routed_experts" in model:
        moe = MoEConfig(n_experts=model["n_routed_experts"],
                        top_k=model["num_experts_per_tok"],
                        n_shared=model["n_shared_experts"],
                        first_dense=model["first_k_dense_replace"],
                        capacity_factor=float(model["capacity_factor"]),
                        d_ff=model["moe_intermediate_size"])
    cfg = ArchConfig(
        name=model["name"], n_layers=model["num_hidden_layers"],
        d_model=model["hidden_size"], n_heads=model["num_attention_heads"],
        n_kv_heads=model["num_key_value_heads"],
        d_ff=model["intermediate_size"], vocab=model["vocab_size"],
        pattern=("moe",) if moe else ("dense",), moe=moe,
        rope_theta=float(model["rope_theta"]),
        head_dim=model.get("head_dim"), dtype=model["torch_dtype"])
    over = dict(model.get("program", {}))
    if "moe" in over:
        given = over.pop("moe")
        _known(MoEConfig, given, f"{model['name']}: program.moe")
        over["moe"] = replace(cfg.moe, **given) if cfg.moe \
            else MoEConfig(**given)
    _known(ArchConfig, over, f"{model['name']}: program")
    return cfg.with_(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in over.items()})


def _known(cls, given: dict, where: str) -> None:
    unknown = sorted(set(given) - {f.name for f in fields(cls)})
    if unknown:
        raise ValueError(f"{where}: {cls.__name__} has no field "
                         f"{', '.join(map(repr, unknown))}")


def serve(params, cfg, mix: traffic.Mix, prompts: list, device) -> Batch:
    """One static batch through the program."""
    from repro_torch.launch.serve import serve_requests

    t_send = time.perf_counter()
    res = serve_requests(params, cfg, prompts, mix.batch, mix.output_tokens,
                         device)
    t_end = time.perf_counter()
    return Batch(prompts, t_send, t_end, sum(res["prefill_s"]),
                 sum(res["decode_s"]), res["tokens"])


def warm(params, cfg, mix: traffic.Mix, prompts: list, device,
         steps: int = 2) -> None:
    """The window's shapes once, through the program's step builders: a
    batch's left-padded prefill into a cache of the window's size, then
    ``steps`` decode steps (every decode step has the same shapes)."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    cache = init_cache(cfg, len(prompts), plen + mix.output_tokens, device)
    logits, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks).to(device)}, cache)
    decode = make_decode_step(cfg)
    for _ in range(steps):
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, cache = decode(params, cache, {"tokens": cur})
    logits.cpu()


def failed(b: Batch, mix: traffic.Mix, vocab: int) -> int:
    """Requests of ``b`` without their tokens, or with one out of range."""
    bad = len(b.prompts) - len(b.tokens)
    for t in b.tokens:
        t = np.asarray(t)
        bad += int(t.shape != (mix.output_tokens + 1,)
                   or bool(((t < 0) | (t >= vocab)).any()))
    return bad


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float = T_START) -> tuple[dict, dict] | None:
    """One run of ``cell``: ``(result, checks)``, or None where a
    forbidden module was loaded."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = program_config(cell.model)
    mix, V = cell.mix, cell.spec.vocab
    t_import = time.perf_counter()
    params = weights.make(cell.spec, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    t_weights = time.perf_counter()
    warm(params, cfg, mix, traffic.warm_batch(mix, V, seed), device)
    if on_card:
        torch.cuda.synchronize(device)
        warm_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: imports {T_IMPORTED - t_start:.3f}, "
          f"then to the weights {t_import - T_IMPORTED:.3f}, weights "
          f"{t_weights - t_import:.3f}, "
          f"warm batch {t_start + setup_s - t_weights:.3f}", file=sys.stderr)

    batches, t0 = [], time.perf_counter()
    while True:
        batches.append(serve(params, cfg, mix,
                             traffic.batch(mix, V, seed, len(batches)),
                             device))
        if batches[-1].t_end - t0 >= seconds:
            break
    run = Run(cell.spec, mix, setup_s, batches[-1].t_end - t0, batches)
    print(f"window {run.window_s:.3f} s, {len(batches)} batches: prefill s "
          f"{[round(b.prefill_s, 4) for b in batches]}, decode s "
          f"{[round(b.decode_s, 4) for b in batches]}", file=sys.stderr)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if forbidden_modules():
        return None

    named = []
    if trace:
        n0, k = len(batches), int(cell.settings["trace_batches"])
        run.traced, run.trace = devtrace.traced(lambda: [
            serve(params, cfg, mix, traffic.batch(mix, V, seed, n0 + i),
                  device)
            for i in range(k)])
        named, host = devtrace.traced(lambda: [
            serve(params, cfg, mix, traffic.batch(mix, V, seed, n0 + k),
                  device)], host=True)
        run.trace.idle_by_host = host.idle_by_host
        print(f"batch s: window mean "
              f"{run.window_s / len(batches):.4f}, traced (the device "
              f"alone) {[round(b.t_end - b.t_send, 4) for b in run.traced]},"
              f" traced with the host's operations "
              f"{[round(b.t_end - b.t_send, 4) for b in named]}",
              file=sys.stderr)
    served = batches + run.traced + named
    memory_peak = max(warm_peak, run.peak_bytes) if on_card else 0

    picked = judge.pick(served, int(cell.settings["check_batches"]), seed)
    mms = ((ref.bf16_matmul,) if judge.EXCESS in cell.settings["limits"]
           else ())
    parts = [judge.served_gaps(params, cell.spec, served[i].prompts,
                               served[i].tokens, device, mms)
             for i in picked]
    got = judge.stats(*(torch.cat([p[k].flatten() for p in parts])
                        for k in range(len(mms) + 1)))
    n_failed = sum(failed(b, mix, V) for b in served)
    checks = {name: {"value": got[name], "limit": float(limit)}
              for name, limit in cell.settings["limits"].items()}
    checks["failed_requests"] = {"value": n_failed, "limit": 0}

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": sum(len(b.prompts) for b in served),
              "failed": n_failed, "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one intra-op thread: the run's process keeps to one core's worth of
    # threads; in turns against torch's default, decode's pace on the
    # card is the same within the runs' spread (PERF.md)
    torch.set_num_threads(1)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if out is None or bad:
        print(f"modules of the JAX package or JAX were loaded: {bad}",
              file=sys.stderr)
        return 3
    result, checks = out
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
