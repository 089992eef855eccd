"""iter_s: the window's length over the iterations done in it (host clock):
every iteration that ended inside the window counts whole, the one still
running when it closed by the share of its wall that lay inside, so that
the reading moves smoothly with the port's speed rather than jumping by an
iteration where the window's end falls."""


def read(ctx):
    done = 0.0
    for r in ctx.steady:
        if r["end"] <= ctx.window_s:
            done += 1.0
        elif r["start"] < ctx.window_s:
            done += (ctx.window_s - r["start"]) / r["wall"]
    return ctx.window_s / done
