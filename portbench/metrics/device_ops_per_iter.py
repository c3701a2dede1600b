"""Device operations (kernels, copies, fills) in the traced stretch per
CG iteration: what one iteration of the operator tree costs in launches."""


def read(ctx):
    s = ctx.summary
    if not s or not s["requests"] or not s["device_ops"]:
        return None
    return s["device_ops"] / (s["requests"] * int(ctx.cfg["maxiter"]))
