"""Small cells for the CPU tests: the two configurations' shapes (MoE with
a dense first layer and shared experts; dense GQA) and dense GQA over a
sliding window, at a few hundred thousand parameters, served a few short
batches."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spec, traffic  # noqa: E402
from bench.reference import spec as model_spec  # noqa: E402

MOE = {"name": "tiny-moe", "hidden_size": 64, "num_hidden_layers": 3,
       "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
       "intermediate_size": 96, "moe_intermediate_size": 32,
       "n_routed_experts": 8, "num_experts_per_tok": 3,
       "n_shared_experts": 2, "first_k_dense_replace": 1,
       "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
       "hidden_act": "silu", "norm_topk_prob": True,
       "tie_word_embeddings": True, "torch_dtype": "bfloat16",
       "capacity_factor": 1.0,
       "blocks": {"dense": ["gqa", "swiglu"], "moe": ["gqa", "deepseek_moe"]}}
DENSE = {"name": "tiny-dense", "hidden_size": 64, "num_hidden_layers": 3,
         "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 16,
         "intermediate_size": 128, "vocab_size": 256, "rope_theta": 5e6,
         "rms_norm_eps": 1e-6, "hidden_act": "silu",
         "tie_word_embeddings": True, "torch_dtype": "bfloat16",
         "blocks": {"dense": ["gqa", "swiglu"]}}
# dense GQA over a sliding window of 8, shorter than the prompts: the
# block kind ``gqa_window`` for the reference, ``window`` for the program
WINDOW = dict(DENSE, name="tiny-window", sliding_window=8,
              program={"window": 8},
              blocks={"dense": ["gqa_window", "swiglu"]})
MIX = traffic.Mix(batch=3, prompt_min=5, prompt_max=24, dist="log_uniform",
                  output_tokens=5)
SETTINGS = {"check_batches": 2, "trace_batches": 1}


def cell(model: dict, limit: float, mix: traffic.Mix = MIX) -> spec.Cell:
    bench = spec.load_benchmark()
    return spec.Cell(
        name="tiny", chips=1, model=model, spec=model_spec.from_dict(model),
        mix=mix, settings=dict(SETTINGS, limits={"logit_gap_max": limit}),
        end_to_end=[m for m in bench["end_to_end"]
                    if m["name"] in ("out_tok_s", "setup_s", "tpot_ms")],
        per_layer=[m for m in bench["per_layer"]
                   if m["name"] in ("mfu", "idle_pct", "prefill_ms")])
