"""Share of the traced pass in which no operation ran on the device: one
minus the union of the profiler's device intervals over the pass's wall
time, in percent (not nvidia-smi's utilization.gpu)."""

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
