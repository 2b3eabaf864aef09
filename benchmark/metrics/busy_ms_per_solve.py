"""Device busy time (union of operation intervals) per solve of the window."""


def read(ctx):
    t = ctx["trace"]
    if not t["devices"] or not t["busy_s"]:
        return None
    return 1e3 * t["busy_s"] / t["solves"]
