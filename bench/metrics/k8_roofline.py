"""K8's share of its roofline over the traced batches: the causal
attention of every prefill at its padded length (``work.k8_flops``,
``work.k8_bytes``) over K8's device time."""
from bench import work


def read(run):
    t = run.trace.class_seconds("K8 flash_attention") if run.trace else 0
    if not t:
        return None
    flops = sum(work.k8_flops(run.spec, len(b.prompts), b.plen)
                for b in run.traced)
    nbytes = sum(work.k8_bytes(run.spec, len(b.prompts), b.plen)
                 for b in run.traced)
    return work.roofline_pct(flops, nbytes, t)
