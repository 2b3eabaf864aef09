"""Wall time per RBCD round, over the window's solves that ran without the
profiler (its per-kernel cost would inflate the round)."""


def read(ctx):
    plain = [r for r in ctx["solves"] if not r["traced"] and "rounds" in r]
    rounds = sum(r["rounds"] for r in plain)
    if not rounds:
        return None
    return 1e3 * sum(r["seconds"] for r in plain) / rounds
