"""The share of the traced attack window in which no operation ran on the device: 100 less the
union of the device's intervals over the window's length (%)."""


def read(run):
    if run.trace is None or run.traffic["kind"] != "attack":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
