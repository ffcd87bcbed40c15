"""idle_share.embed: the share of the profiled stretch of requests in
which no operation ran on the device (100 x (1 - union of the device's
operation intervals / the stretch's length on the host clock)). Layer:
the device."""


def read(ctx):
    t = ctx.traced
    if t is None or not t.device or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
