"""setup_s: from the process's start to the window's: imports, loading the
kernel library (building it on a checkout's first run), making the data,
the cold fits the traffic starts from (one a history) and the warm-up
iteration (host clock)."""


def read(ctx):
    return ctx.setup_s
