"""Device-to-host copies per solve of the window: the result read back, and
each predicate a device-side loop hands to the host."""


def read(ctx):
    t = ctx["trace"]
    if not t["devices"] or not t["memcpy_d2h"]:
        return None
    return t["memcpy_d2h"] / t["solves"]
