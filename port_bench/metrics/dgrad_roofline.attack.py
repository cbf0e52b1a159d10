"""The dgrad layer's share of its roofline in the traced attack steps: the least time of every
frozen linear's input gradient that the layer computes (weights of both dims at least 1024 and
multiples of 128: each the larger of its operations over the bf16 peak and its bytes over the
memory bandwidth, work/common.py) over the device time of the kernels launched under the host
operation that computes them, LinearPdxBackward (%). Silent where the traced steps launched
another count of such operations than the work lists."""

import sys

from port_bench.work import common

HOST_OPS = ("LinearPdxBackward",)


def read(run):
    tr = run.trace
    if tr is None or run.traffic["kind"] != "attack":
        return None
    c, t, w = run.config, run.traffic, run.window
    least, calls = 0.0, 0
    for lens in tr.lens:
        step = common.attack_step(run.work, c, t["batch_size"], w["t"], lens, t["source_hw"], w["head"])
        mine = [x for x in step["linears"] if common.dgrad_eligible(x[1], x[2])]
        least += sum(common.least_seconds(*common.linear_input_grad(m, n, k)) for m, n, k, _ in mine)
        calls += len(mine)
    seconds, ops = tr.under(HOST_OPS)
    if ops != calls or seconds <= 0:
        print(f"dgrad_roofline.attack: {ops} host operations launched work, the work lists {calls}",
              file=sys.stderr)
        return None
    return 100.0 * least / seconds
