"""Timing scripts of the port, run on a GPU host (see each module)."""
