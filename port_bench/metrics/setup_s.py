"""Seconds from the process's start to the window's first step: imports, the weights drawn on the
device, the tokenizer and the prompt pools, the warm-up (host clock)."""


def read(run):
    return run.window["setup_s"]
