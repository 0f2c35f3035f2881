"""Training samples per second: the rows of every step of the window over
the window's time, each step ended by a synchronise (host clock)."""


def read(ctx):
    r = getattr(ctx, "run", None)
    if r is None or not r.steps or r.elapsed <= 0:
        return None
    return len(r.steps) * r.batch / r.elapsed
