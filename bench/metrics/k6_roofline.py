"""K6's share of its roofline over the traced batches: the MoE layers'
dispatch and combine gathers of every prefill (one dispatch group of the
whole padded batch) and decode step (one of the batch), by
``work.k6_bytes``, over K6's device time."""
from bench import work


def read(run):
    t = run.trace.class_seconds("K6 ragged_gather") if run.trace else 0
    if not t or not run.spec.moe:
        return None
    nbytes = sum(work.k6_bytes(run.spec, len(b.prompts) * b.plen)
                 + run.mix.output_tokens
                 * work.k6_bytes(run.spec, len(b.prompts))
                 for b in run.traced)
    return work.roofline_pct(0, nbytes, t)
