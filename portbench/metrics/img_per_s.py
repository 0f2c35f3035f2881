"""Images per second: every image the window's requests completed, over all
the window's time, the wait for requests still in flight at its close
included (host clock)."""


def read(ctx):
    w = ctx.window
    return len(w.done) / w.elapsed if w.elapsed > 0 else None
