"""RBCD rounds per solve, as the engine's run returns them."""


def read(ctx):
    rounds = [r["rounds"] for r in ctx["solves"] if "rounds" in r]
    if not rounds:
        return None
    return sum(rounds) / len(rounds)
