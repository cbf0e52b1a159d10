"""Attack steps completed in the window over the window's wall time, the window ending in a
synchronization (host clock)."""


def read(run):
    return run.window["units"] / run.window["window_s"]
