"""Calls of the server's dispatch tables over the window that ran a
prepared program (`ShapeDispatch.hits` over hits + misses), in percent."""


def read(ctx):
    d = getattr(ctx, "dispatch", None)
    if not d or sum(d) == 0:
        return None
    return 100.0 * d[0] / (d[0] + d[1])
