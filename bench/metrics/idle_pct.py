"""The device's idle share of the window: 1 - the device's busy seconds a
batch, from a profile of the device alone over the traced batches (the
union of its operations' intervals), over the window's mean batch time on
the host's clock.  Every batch holds the same padded work, so the traced
batches' device time is the window's; their time on the host is not,
since the profile slows the host that paces decode (PERF.md)."""


def read(run):
    if not run.trace or not run.traced:
        return None
    busy = run.trace.busy_s / len(run.traced)
    return 100.0 * (1.0 - busy / (run.window_s / len(run.batches)))
