"""``solves_per_s``: problems solved in the window's calls over the time
from the window's start to the last call's end."""


def read(run):
    return run.window.problems / run.window.wall_s
