"""Kernels launched on the device per solve of the window."""


def read(ctx):
    t = ctx["trace"]
    if not t["devices"] or not t["kernels"]:
        return None
    return t["kernels"] / t["solves"]
