"""Command-line entry points of the port: the trainers, the eval CLI and
the measurement scripts (the measurement scripts need a CUDA card)."""
