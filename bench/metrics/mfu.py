"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's requests (``work.request_flops``: unpadded tokens, active
parameters, causal attention, the unembedding where a token is made)
over the window's seconds."""
from bench import work


def read(run):
    flops = sum(work.request_flops(run.spec, len(p), run.mix.output_tokens)
                for b in run.batches for p in b.prompts)
    return 100.0 * flops / (run.window_s * work.PEAK_BF16_FLOPS)
