"""The decode loop's pace: the window's host milliseconds over the
decode steps started in it."""

from bench.readers import window_steps


def read(record):
    n = len(window_steps(record))
    return 1000.0 * record["seconds"] / n if n else None
