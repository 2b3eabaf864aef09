"""Truncated-CG iterations per solve, as the solver's statistics count them."""


def read(ctx):
    iters = [r["tcg_iters"] for r in ctx["solves"] if "tcg_iters" in r]
    if not iters:
        return None
    return sum(iters) / len(iters)
