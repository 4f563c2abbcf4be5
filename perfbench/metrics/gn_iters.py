"""Mean Gauss-Newton iterations an align (``last_diagnostics.iterations``)."""


def read(ctx):
    return sum(ctx.iterations) / len(ctx.iterations) if ctx.iterations else None
