"""``serve_requests``' decode loop as a replayed CUDA graph
(``launch/serve.py``).

On the CPU the loop stays eager: the served tokens are those of the
eager loop written out here, and only ``decode_eager_steps`` counts.
What the graph replays is ``_DecodeGraph._step`` over the entry's static
cache, so the entry's bookkeeping is checked on the CPU by running that
step eagerly over two batches of one shape (the second prefilled into
the entry's zeroed cache), bitwise against the eager loop, for the
attention, MoE and recurrent kinds.  The entry's key and its one-entry
registry are checked on the CPU too.  The ``gpu`` tests capture and
replay on the card: yi-6b's tokens bitwise the eager loop's,
deepseek-moe-16b's within the eager loop's own spread (the combine's
``index_add_`` sums in no fixed order), recurrent archs over 8 replayed
steps, a second batch of one shape replaying without a capture, a new
shape letting the old entry go, and the recorder keeping the loop eager.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.train.steps import make_decode_step, make_prefill_step

COUNTERS = ("decode_graph_captures", "decode_graph_replays",
            "decode_eager_steps")
GEN = 4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No recorder, and no decode graph held from another test."""
    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.setattr(serve, "_GRAPHS", {})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode loop captures and "
                    "replays a CUDA graph only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _counts() -> dict:
    return {n: REGISTRY.counter(n).value for n in COUNTERS}


def _since(before: dict) -> dict:
    return {n: v - before[n] for n, v in _counts().items()}


def _model(arch: str, device, dtype: str | None = None, seed: int = 0):
    cfg = get_config(arch).reduced()
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, init_params(cfg, gen, device)


def _queue(cfg, lens, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _padded(prompts: list, device) -> torch.Tensor:
    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).to(device)


def _batches(queue: list, batch: int) -> list:
    return [queue[i: i + batch] for i in range(0, len(queue), batch)]


def _eager(params, cfg, queue, batch: int, gen: int, device) -> list:
    """The eager loop: a fresh cache a batch, its prefill, ``gen`` greedy
    steps."""
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = []
    for prompts in _batches(queue, batch):
        toks = _padded(prompts, device)
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + gen, device)
        logits, cache = prefill(params, {"tokens": toks}, cache)
        picked = [serve._greedy(logits)]
        for _ in range(gen):
            logits, cache = decode(params, cache, {"tokens": picked[-1]})
            picked.append(serve._greedy(logits))
        out.extend(torch.cat(picked, 1).cpu().numpy())
    return out


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "yi-6b"])
def test_the_cpu_loop_is_eager_and_serves_the_same_tokens(arch):
    cfg, params = _model(arch, "cpu")
    queue = _queue(cfg, (5, 9, 7, 4, 8))
    before = _counts()
    res = serve.serve_requests(params, cfg, queue, 2, GEN, "cpu")
    _same(res["tokens"], _eager(params, cfg, queue, 2, GEN, "cpu"))
    assert _since(before) == {"decode_graph_captures": 0,
                              "decode_graph_replays": 0,
                              "decode_eager_steps": 3 * GEN}
    assert serve._GRAPHS == {}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "yi-6b",
                                  "recurrentgemma-2b", "xlstm-125m"])
def test_the_entry_step_is_the_eager_step(arch):
    """Two batches of one shape through one entry, each step the body the
    graph captures, run eagerly: the tokens are the eager loop's.  The
    second prefill goes into the entry's cache with the first batch's
    decode rows still in it, zeroed in place; recurrentgemma's prompts
    pass its local window of 16, so its ring wraps."""
    cfg, params = _model(arch, "cpu", "bfloat16")
    lens = (20, 24, 24, 17) if arch == "recurrentgemma-2b" else (6, 9, 9, 4)
    queue = _queue(cfg, lens)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    entry = serve._DecodeGraph(("shape",), init_cache(
        cfg, 2, max(lens) + GEN, "cpu"))
    got = []
    for prompts in _batches(queue, 2):
        toks = _padded(prompts, "cpu")
        logits, cache = prefill(params, {"tokens": toks},
                                entry.prefill_cache())
        entry.start(cache, serve._greedy(logits), ("weights",))
        picked = [entry.tok.clone()]
        for _ in range(GEN):
            entry._step(decode, params)
            picked.append(entry.tok.clone())
        got.extend(torch.cat(picked, 1).numpy())
    # the attention caches; xlstm has none, its states are all replaced
    assert bool(entry.inplace) == (arch != "xlstm-125m")
    assert all(t.dim() == 4 for t in entry.inplace)
    _same(got, _eager(params, cfg, queue, 2, GEN, "cpu"))


def test_a_leaf_a_step_reshapes_is_refused():
    static = {"kv": {"pos": torch.zeros((), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="cannot replay"):
        serve._copy_replaced(static, {"kv": {"pos": torch.zeros(
            (), dtype=torch.int64)}})
    serve._copy_replaced(static, {"kv": {"pos": torch.full(
        (), 3, dtype=torch.int32)}})
    assert int(static["kv"]["pos"]) == 3


def test_the_keys_and_the_one_entry_a_device():
    """The weights' key is the same for the same weights across calls, and
    moves when a weight leaf is reallocated or the step builder changes;
    the registry holds one entry a device, made anew on another config,
    ``B`` or ``S``; an entry drops its graph on other weights."""
    cfg, params = _model("yi-6b", "cpu")
    wkey = serve._weights_key(params, make_decode_step)
    assert wkey == serve._weights_key(params, make_decode_step)
    moved = dict(params, final_norm={k: v.clone() for k, v in
                                     params["final_norm"].items()})
    assert serve._weights_key(moved, make_decode_step) != wkey
    assert serve._weights_key(params, lambda c: None) != wkey
    dev = torch.device("cpu")
    first = serve._decode_graph(dev, cfg, 2, 12)
    assert serve._decode_graph(dev, cfg, 2, 12) is first
    for c, b, s in ((cfg, 3, 12), (cfg, 3, 13),
                    (cfg.with_(rope_theta=1.0), 3, 13)):
        entry = serve._decode_graph(dev, c, b, s)
        assert entry is not first and serve._GRAPHS == {dev: entry}
        assert entry.cache["body"][0][0]["kv"]["k"].shape[:2] == (b, s)
        first = entry
    cur = torch.zeros((3, 1), dtype=torch.int32)
    entry.start(entry.prefill_cache(), cur, wkey)
    entry.graph = "captured"
    entry.start(entry.prefill_cache(), cur, wkey)
    assert entry.graph == "captured"
    entry.start(entry.prefill_cache(), cur, serve._weights_key(
        moved, make_decode_step))
    assert entry.graph is None


def test_the_recorder_keeps_the_span_tree():
    """With the recorder on, a batch records its prefill and one
    ``serve/decode_step`` a step, each holding its layers' spans, and
    only eager steps are counted."""
    cfg, params = _model("deepseek-moe-16b", "cpu")
    queue = _queue(cfg, (5, 9, 7))
    rec = trace.enable(trace.TraceRecorder())
    before = _counts()
    try:
        serve.serve_requests(params, cfg, queue, 2, GEN, "cpu")
    finally:
        trace.disable()
    assert _since(before)["decode_eager_steps"] == 2 * GEN
    names = [s.name for s in rec.events]
    assert names.count("serve/batch") == 2
    assert names.count("serve/prefill") == 2
    assert names.count("serve/decode_step") == 2 * GEN
    steps = {s.id for s in rec.events if s.name == "serve/decode_step"}
    under = [s.name for s in rec.events if s.parent in steps]
    assert under.count("model/attention") == 2 * GEN * cfg.n_layers
    assert under.count("model/moe") == 2 * GEN * (cfg.n_layers - 1)


# --------------------------------------------------------------- the card

def _served_gaps(params, cfg, queue, tokens, batch: int, gen: int,
                 device) -> float:
    """The mean gap of ``tokens`` under the eager loop fed them: at each
    position, how far the eager logit of the served token lies below the
    eager best."""
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    gaps = []
    for j, prompts in enumerate(_batches(queue, batch)):
        served = torch.as_tensor(np.stack(
            tokens[j * batch: j * batch + len(prompts)]), device=device)
        toks = _padded(prompts, device)
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + gen, device)
        logits, cache = prefill(params, {"tokens": toks}, cache)
        rows = [logits[:, -1]]
        for i in range(gen):
            logits, cache = decode(params, cache,
                                   {"tokens": served[:, i: i + 1]})
            rows.append(logits[:, -1])
        lg = torch.stack(rows, 1).float()
        gaps.append(lg.max(-1).values - lg.gather(
            -1, served.long()[..., None]).squeeze(-1))
    return float(torch.cat([g.flatten() for g in gaps]).mean())


@pytest.mark.gpu
def test_yi_replays_bitwise_and_keeps_one_entry(cuda_device):
    """Three batches of 2: the first two of one shape (one capture, the
    second batch replays every step), the third of a new one, which lets
    the first entry go and captures again."""
    cfg, params = _model("yi-6b", cuda_device, "bfloat16")
    queue = _queue(cfg, (5, 9, 9, 7, 4, 6))
    before = _counts()
    res = serve.serve_requests(params, cfg, queue, 2, GEN, cuda_device)
    assert _since(before) == {"decode_graph_captures": 2,
                              "decode_graph_replays": 3 * GEN - 2,
                              "decode_eager_steps": 2}
    (entry,) = serve._GRAPHS.values()
    assert entry.key[1:] == (2, 6 + GEN)
    _same(res["tokens"], _eager(params, cfg, queue, 2, GEN, cuda_device))
    before = _counts()
    again = serve.serve_requests(params, cfg, queue[4:], 2, GEN,
                                 cuda_device)
    assert serve._GRAPHS[cuda_device] is entry
    assert _since(before) == {"decode_graph_captures": 0,
                              "decode_graph_replays": GEN,
                              "decode_eager_steps": 0}
    _same(again["tokens"], res["tokens"][4:])
    # the same values in new tensors: the cache is kept, the graph taken
    # anew, and it reads the new tensors
    moved = {k: v for k, v in params.items()}
    moved["embed"] = {k: v.clone() for k, v in params["embed"].items()}
    params["embed"]["e"].zero_()
    before = _counts()
    again = serve.serve_requests(moved, cfg, queue[4:], 2, GEN, cuda_device)
    assert serve._GRAPHS[cuda_device] is entry
    assert _since(before) == {"decode_graph_captures": 1,
                              "decode_graph_replays": GEN - 1,
                              "decode_eager_steps": 1}
    _same(again["tokens"], res["tokens"][4:])


@pytest.mark.gpu
def test_deepseek_replays_within_the_eager_spread(cuda_device):
    cfg, params = _model("deepseek-moe-16b", cuda_device)
    queue = _queue(cfg, (5, 9, 8, 9))
    graph = serve.serve_requests(params, cfg, queue, 2, GEN, cuda_device)
    assert len(serve._GRAPHS) == 1
    eager = [_eager(params, cfg, queue, 2, GEN, cuda_device)
             for _ in range(2)]
    spread = max(_served_gaps(params, cfg, queue, e, 2, GEN, cuda_device)
                 for e in eager)
    got = _served_gaps(params, cfg, queue, graph["tokens"], 2, GEN,
                       cuda_device)
    assert got <= spread + 1e-4, (got, spread)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_recurrent_archs_replay_8_steps(cuda_device, arch):
    """Two batches of one shape, 8 steps each: the recurrent states the
    steps replace are copied back into the graph's inputs at each
    replay, and the second prefill's into them before its steps."""
    cfg, params = _model(arch, cuda_device, "bfloat16")
    lens = (20, 24, 24, 17) if arch == "recurrentgemma-2b" else (6, 9, 9, 4)
    queue = _queue(cfg, lens)
    before = _counts()
    res = serve.serve_requests(params, cfg, queue, 2, 8, cuda_device)
    assert _since(before) == {"decode_graph_captures": 1,
                              "decode_graph_replays": 15,
                              "decode_eager_steps": 1}
    _same(res["tokens"], _eager(params, cfg, queue, 2, 8, cuda_device))


@pytest.mark.gpu
def test_the_recorder_keeps_the_card_eager(cuda_device):
    cfg, params = _model("yi-6b", cuda_device, "bfloat16")
    queue = _queue(cfg, (5, 9))
    rec = trace.enable(trace.TraceRecorder())
    before = _counts()
    try:
        res = serve.serve_requests(params, cfg, queue, 2, GEN, cuda_device)
    finally:
        trace.disable()
    assert _since(before) == {"decode_graph_captures": 0,
                              "decode_graph_replays": 0,
                              "decode_eager_steps": GEN}
    assert serve._GRAPHS == {}
    assert [s.name for s in rec.events].count("serve/decode_step") == GEN
    _same(res["tokens"], _eager(params, cfg, queue, 2, GEN, cuda_device))
