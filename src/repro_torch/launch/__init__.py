"""Entry points of the port: the batched serving loop (``serve``)."""
