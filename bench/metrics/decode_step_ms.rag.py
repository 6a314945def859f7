"""A decode step of the program (``serve_requests``' ``decode_s`` over the
batch's steps), the median over the window's batches."""
import statistics


def read(run):
    return 1e3 * statistics.median(b.decode_s / run.mix.output_tokens
                                   for b in run.batches)
