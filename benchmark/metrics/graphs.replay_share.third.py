"""Chunk steps replayed from a CUDA graph over every chunk step of the
traced calls of bundle64.third (engine/graphs.py's replay counter)."""

from benchlib import phases


def read(ctx):
    return phases.replay_share(ctx)
