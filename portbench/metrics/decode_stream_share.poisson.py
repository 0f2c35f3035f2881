"""Stream time of the VAE decodes over that of the denoise trajectories and
the decodes, over the window's flushes, in percent: the program's `decode`
and `denoise` spans, each timed by CUDA events recorded on the stream at
its start and end. The decode runs eagerly, so its stream time includes
the device's waits for the host's launches where they fall behind the
device: the host paces this share, and a faster decode kernel moves it
only where the launches keep ahead."""


def read(ctx):
    dec = sum(s.device_ms for s in ctx.program if s.name == "decode" and s.device_ms)
    den = sum(s.device_ms for s in ctx.program if s.name == "denoise" and s.device_ms)
    return 100.0 * dec / (dec + den) if dec + den > 0 else None
