"""The attack's share of the card's bf16 peak: every step's work in the measured window (work/:
forward products, input-gradient products, attention forward and backward; no weight gradients),
over the window's wall time and the peak of peaks.json (%)."""

from port_bench.work import common


def read(run):
    if run.traffic["kind"] != "attack":
        return None
    c, tr, w = run.config, run.traffic, run.window
    ops = sum(common.attack_step(run.work, c, tr["batch_size"], w["t"], lens, tr["source_hw"], w["head"])["ops"]
              for lens in w["lens"])
    return 100.0 * ops / w["window_s"] / common.peaks()["bf16_flops"]
