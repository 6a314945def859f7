"""Process start to the first timed batch: CUDA, the program's kernels
built or loaded, the weights drawn on the card, one warm batch."""


def read(run):
    return run.setup_s
