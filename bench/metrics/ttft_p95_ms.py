"""Time to first token, the 95th percentile over every request of the
window: each request's send to its batch's first token (a static batch
sends all its requests at once)."""
import statistics


def read(run):
    ttft = [b.ttft_s * 1e3 for b in run.batches for _ in b.prompts]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=100, method="inclusive")[94]
