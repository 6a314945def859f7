"""The program's prefill of a batch (``serve_requests``' ``prefill_s``,
which ends in a device sync), the median over the window's batches."""
import statistics


def read(run):
    return 1e3 * statistics.median(b.prefill_s for b in run.batches)
