"""The decoder's causal attention's share of its roofline in the traced attack steps: the least
time of each layer's forward and backward (work/common.py::causal_attention: the real tokens'
causal pairs, each tensor read or written once) over the device time of the kernels launched
under the host operations that compute them, FlashAttention and FusedAttention and their
backwards (%). Silent where their count is not two a layer and step."""

import sys

from port_bench.work import common

HOST_OPS = ("FlashAttention", "FlashAttentionBackward", "FusedAttention", "FusedAttentionBackward")


def read(run):
    tr = run.trace
    if tr is None or run.traffic["kind"] != "attack":
        return None
    c, t, w = run.config, run.traffic, run.window
    least, calls = 0.0, 0
    for lens in tr.lens:
        step = common.attack_step(run.work, c, t["batch_size"], w["t"], lens, t["source_hw"], w["head"])
        least += sum(common.least_seconds(*call[part]) for call in step["causal"] for part in ("fwd", "bwd"))
        calls += 2 * len(step["causal"])
    seconds, ops = tr.under(HOST_OPS)
    if ops != calls or seconds <= 0:
        print(f"causal_attn_roofline.attack: {ops} host operations launched work, the work lists {calls}",
              file=sys.stderr)
        return None
    return 100.0 * least / seconds
