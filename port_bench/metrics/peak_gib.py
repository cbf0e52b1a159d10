"""The device memory allocated at most during the window, in GiB (torch.cuda.max_memory_allocated
after a reset at the window's start)."""


def read(run):
    return run.window["peak_gib"]
