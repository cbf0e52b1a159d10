"""The host's time to enqueue one attack step: the host clock around each step call of the
measured window, with no synchronization, averaged over every step."""


def read(run):
    enqueue = run.window.get("enqueue_s")
    return 1e3 * sum(enqueue) / len(enqueue) if enqueue else None
