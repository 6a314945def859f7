"""Time per output token: the window's decode seconds over its decode
steps."""


def read(run):
    steps = sum(run.mix.output_tokens for _ in run.batches)
    if not steps:
        return None
    return 1e3 * sum(b.decode_s for b in run.batches) / steps
