"""Seconds from the process's start to the window's start: imports, the
card's start, the inputs, the program's set-up and the warm-up (with a
first run's builds)."""


def read(ctx):
    return ctx.setup_s
