"""Pairs completed in the window over the window's seconds (host clock;
the window ends when the request that crosses ``--seconds`` returns)."""


def read(run):
    return run.pairs / run.window_s
