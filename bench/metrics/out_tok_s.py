"""Output tokens of the window (each request's prefill token and decode
tokens, as returned to it) over the whole window."""


def read(run):
    return sum(len(t) for b in run.batches for t in b.tokens) / run.window_s
