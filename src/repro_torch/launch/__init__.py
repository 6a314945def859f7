"""Entry points of the port: the batched serving loop (``serve``) and the
training driver (``train``)."""
