"""The plain reference of the served models: a float32 PyTorch forward of
the dense and MoE decoders that the cells serve, written from the
published descriptions and the configuration files, independent of the
program.  It imports nothing of the program."""
