"""Experiment tracker: a filesystem analysis API over the runs/ and tests/ artifacts (per
experiment its config, saved iterations, in-training test CSVs, judged safety details, SafeBench
generations and ASR dynamics). Counterpart of adversarialvlm_tpu/eval/experiment_tracker.py.

The card's machine has no pandas: tables are read and written through ``eval/tables.py``, and
where the JAX package returns a DataFrame the port returns its rows, a list of {column: value}
dicts in the frame's row and column order (``DataFrame.to_dict("records")``), the values typed as
pandas reads them.
"""

from __future__ import annotations

import json
import os
import re

from adversarialvlm_tpu_torch.eval.tables import read_rows, read_table

_ITER_RE = re.compile(r"optimized_image_iter_(\d+)\.png$")
_TEST_RE = re.compile(r"test_results_iter_(\d+)\.csv$")
_SAFETY_RE = re.compile(r"safety_details_iter_(\d+)\.csv$")
_TEST_DIR_RE = re.compile(r"^(.+)_(\d+)$")


def _iterations(directory: str, pattern: re.Pattern) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := pattern.match(f)))


def _subdirs(path: str) -> list[str]:
    if not os.path.isdir(path):
        return []
    return sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))


class ExperimentTracker:
    def __init__(self, runs_path: str = "./runs", tests_path: str = "./tests"):
        self.runs_path = runs_path
        self.tests_path = tests_path

    # ----------------------------------------------------------- discovery

    def list_experiments(self) -> list[str]:
        return _subdirs(self.runs_path)

    def list_test_runs(self) -> list[str]:
        return _subdirs(self.tests_path)

    def get_config(self, exp: str) -> dict | None:
        p = os.path.join(self.runs_path, exp, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def get_checkpoint_iterations(self, exp: str) -> list[int]:
        return _iterations(os.path.join(self.runs_path, exp), _ITER_RE)

    def get_available_test_steps(self, exp: str) -> list[int]:
        return _iterations(os.path.join(self.runs_path, exp), _TEST_RE)

    def get_judged_steps(self, exp: str, judge: str = "gemma-3-4b-it") -> list[int]:
        return _iterations(os.path.join(self.runs_path, exp, "safety_details", judge), _SAFETY_RE)

    # --------------------------------------------------------------- loads

    def load_generations(self, exp: str, iteration: int) -> list[dict]:
        return read_rows(os.path.join(self.runs_path, exp, f"test_results_iter_{iteration}.csv"))

    def load_safety_details(self, exp: str, iteration: int, judge: str = "gemma-3-4b-it") -> list[dict]:
        return read_rows(os.path.join(self.runs_path, exp, "safety_details", judge,
                                      f"safety_details_iter_{iteration}.csv"), sep=";")

    def find_experiments(self, pattern: str) -> list[str]:
        """Regex search over runs/ experiment names, case-insensitive (experiment_tracker.py:97-101)."""
        rx = re.compile(pattern, re.IGNORECASE)
        return [e for e in self.list_experiments() if rx.search(e)]

    # ---------------------------------------------------------- tests/ side

    def scan_tests(self) -> dict:
        """tests/ scanned for ``<exp>_<step>/<model_suffix>/`` benchmark runs
        (experiment_tracker.py:105-145): per model suffix, whether the 23-category inference CSVs
        are complete and the judged mean ASR (mean_result_gemma.txt) when present."""
        out: dict[str, dict[int, dict]] = {}
        for d in self.list_test_runs():
            m = _TEST_DIR_RE.match(d)
            if not m:
                continue
            exp, step = m.group(1), int(m.group(2))
            test_dir = os.path.join(self.tests_path, d)
            models = {}
            for suf in sorted(os.listdir(test_dir)):
                mdir = os.path.join(test_dir, suf)
                if not os.path.isdir(mdir):
                    continue
                csvs = [f for f in os.listdir(mdir) if f.endswith(".csv") and f[:-4].isdigit()]
                asr = None
                mean_path = os.path.join(mdir, "mean_result_gemma.txt")
                if os.path.exists(mean_path):
                    try:
                        with open(mean_path) as fh:
                            asr = float(fh.read().strip())
                    except (ValueError, OSError):
                        pass  # a malformed or unreadable entry is skipped, the scan goes on
                models[suf] = {"has_inference": len(csvs) >= 23, "num_categories": len(csvs), "asr": asr}
            out.setdefault(exp, {})[step] = {"path": test_dir, "models": models}
        return out

    def tests_summary(self) -> list[dict]:
        """A row per (experiment, step) with one ``<suffix>_asr`` / ``<suffix>_has_inference``
        pair per model suffix seen (experiment_tracker.py:147-167)."""
        scanned = self.scan_tests()
        suffixes: list[str] = []
        for steps in scanned.values():
            for info in steps.values():
                suffixes.extend(s for s in info["models"] if s not in suffixes)
        rows = []
        for exp, steps in sorted(scanned.items()):
            for step, info in sorted(steps.items()):
                row: dict = {"experiment": exp, "step": step}
                for suf in suffixes:
                    m = info["models"].get(suf)
                    row[f"{suf}_asr"] = m["asr"] if m else None
                    row[f"{suf}_has_inference"] = bool(m and m["has_inference"])
                rows.append(row)
        return rows

    def load_safebench_generations(self, exp: str, step: int, model_suffix: str,
                                   category: int) -> list[dict] | None:
        """One SafeBench category's generations, tests/<exp>_<step>/<suffix>/<category>.csv: every
        producer writes one generation a row and no header, read as strings under the column
        ``generation`` (experiment_tracker.py:169-186)."""
        p = os.path.join(self.tests_path, f"{exp}_{step}", model_suffix, f"{category}.csv")
        if not os.path.exists(p):
            return None
        import csv

        with open(p, newline="", encoding="utf-8") as f:
            return [{"generation": r[0] if r and r[0] != "" else float("nan")} for r in csv.reader(f)]

    def load_guard_results(self, exp: str, step: int, model_suffix: str) -> list[dict] | None:
        """The per-category judged ASR table (results_gemma.csv)."""
        p = os.path.join(self.tests_path, f"{exp}_{step}", model_suffix, "results_gemma.csv")
        return read_rows(p) if os.path.exists(p) else None

    def load_guard_verdicts(self, exp: str, step: int, model_suffix: str) -> list[dict] | None:
        """The raw per-answer judge verdicts (guard_gemma.csv)."""
        p = os.path.join(self.tests_path, f"{exp}_{step}", model_suffix, "guard_gemma.csv")
        return read_rows(p) if os.path.exists(p) else None

    def load_unsafe_metrics(self, exp: str) -> list[dict] | None:
        """unsafe_metrics_models.csv, its first column the index (``index_col=0``): the rows carry
        it under its header name."""
        p = os.path.join(self.runs_path, exp, "unsafe_metrics_models.csv")
        return read_rows(p) if os.path.exists(p) else None

    def get_best_step(self, exp: str) -> int | None:
        p = os.path.join(self.runs_path, exp, "best.txt")
        if os.path.exists(p):
            with open(p) as f:
                return int(f.read().strip())
        return None

    # ------------------------------------------------------------ analysis

    def safety_summary(self, exp: str, judge: str = "gemma-3-4b-it") -> list[dict]:
        """(iteration, model, asr) rows from the judged details, models in sorted order as
        pandas' groupby gives them; asr is the share of answers judged not safe."""
        rows = []
        for it in self.get_judged_steps(exp, judge):
            names, cols = read_table(os.path.join(self.runs_path, exp, "safety_details", judge,
                                                  f"safety_details_iter_{it}.csv"), sep=";")
            by_model: dict = {}
            for model, safe in zip(cols["model"], cols["is_safe"]):
                by_model.setdefault(model, []).append(bool(safe))
            for model in sorted(by_model):
                flags = by_model[model]
                rows.append({"iteration": it, "model": model,
                             "asr": float(sum(not f for f in flags) / len(flags))})
        return rows

    def safety_step_summary(self, exp: str, judge: str = "gemma-3-4b-it") -> list[dict]:
        """Per judged step: step, total_evaluations, unsafe_count, asr, models
        (experiment_tracker.py:228-249)."""
        rows = []
        for it in self.get_judged_steps(exp, judge):
            details = self.load_safety_details(exp, it, judge)
            unsafe = sum(not bool(r["is_safe"]) for r in details)
            rows.append({
                "step": it,
                "total_evaluations": len(details),
                "unsafe_count": int(unsafe),
                "asr": float(unsafe / len(details)) if details else 0.0,
                "models": sorted({r["model"] for r in details}),
            })
        return rows

    def runs_summary(self) -> list[dict]:
        rows = []
        for exp in self.list_experiments():
            cfg = self.get_config(exp) or {}
            rows.append({
                "experiment": exp,
                "num_checkpoints": len(self.get_checkpoint_iterations(exp)),
                "num_test_steps": len(self.get_available_test_steps(exp)),
                "best_step": self.get_best_step(exp),
                "num_iterations": cfg.get("num_iterations"),
                "epsilon": cfg.get("epsilon"),
                "models": cfg.get("model_names") or cfg.get("model_name"),
            })
        return rows

    def runs_with_best_steps(self) -> list[dict]:
        """Only the experiments whose best step is computed (experiment_tracker.py:268-274)."""
        return [r for r in self.runs_summary() if r["best_step"] is not None]

    def status(self, exp: str) -> dict:
        """The pipeline stages' status of one experiment."""
        test_steps = self.get_available_test_steps(exp)
        judged = self.get_judged_steps(exp)
        return {
            "experiment": exp,
            "has_config": self.get_config(exp) is not None,
            "checkpoints": len(self.get_checkpoint_iterations(exp)),
            "test_steps": len(test_steps),
            "judged_steps": len(judged),
            "judging_complete": bool(test_steps) and set(test_steps) <= set(judged),
            "best_step": self.get_best_step(exp),
            # the exact name, as scan_tests parses it: a prefix test would also claim 'exp_v2_500'
            "has_safebench": any((m := _TEST_DIR_RE.match(d)) and m.group(1) == exp
                                 for d in self.list_test_runs()),
        }

    def plot_asr_dynamics(self, exp: str, out_path: str | None = None, judge: str = "gemma-3-4b-it"):
        """The ASR of each model over the judged iterations as a PNG (runs/<exp>/asr_dynamics.png
        by default); None without judged details. matplotlib is imported here, as in the JAX
        package: where it is missing (the card's machine) this raises ImportError."""
        summary = self.safety_summary(exp, judge)
        if not summary:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        models = sorted({r["model"] for r in summary})
        plt.figure(figsize=(12, 6))
        for model in models:
            pts = sorted((r["iteration"], r["asr"]) for r in summary if r["model"] == model)
            plt.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=model)
        plt.xlabel("Iteration")
        plt.ylabel("ASR")
        plt.title(f"ASR dynamics ({exp})")
        plt.legend()
        plt.tight_layout()
        out_path = out_path or os.path.join(self.runs_path, exp, "asr_dynamics.png")
        plt.savefig(out_path)
        plt.close()
        return out_path
