"""The port's experiment tracker and post-hoc re-tester (eval/experiment_tracker.py,
eval/test_post.py, cli/test_post.py) against the JAX modules, on the CPU.

Runs/ and tests/ trees are fabricated with numpy seeds: configs, saved images, in-training test
CSVs, judged safety details, SafeBench generations, guard results. Where the JAX tracker returns a
DataFrame, the port returns its rows, compared with ``to_dict("records")``. Where the
re-tester's summary.csv is held byte for byte, both packages' ``run_model_test`` are replaced by
the same rule, which reports numbers of the image and the iteration it is given, so the files test
the re-tester (image discovery and reading, skips, the summary writer); the port's CLI then runs
on a tiny Qwen2-VL victim alone.
"""

import json
import math
import os

import numpy as np
import pytest

from adversarialvlm_tpu.eval import experiment_tracker as jtracker
from adversarialvlm_tpu.eval import test_post as jpost
from adversarialvlm_tpu_torch.cli import test_post as cli
from adversarialvlm_tpu_torch.eval import experiment_tracker as tracker
from adversarialvlm_tpu_torch.eval import test_post as post
from adversarialvlm_tpu_torch.utils.png import write_png

JUDGE = "gemma-3-4b-it"


def _csv(path, header, rows, sep=","):
    import csv

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        if header:
            w.writerow(header)
        w.writerows(rows)


def _png(path, seed, hw=(28, 42)):
    rng = np.random.default_rng(seed)
    write_png(path, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))


def fabricate_trees(root):
    """runs/ with three experiments (one fully staged, one without judging, one bare) and tests/
    with SafeBench outputs: complete and partial category sets, a judged mean, a malformed mean,
    guard tables, and a directory whose name has no step."""
    runs, tests = os.path.join(root, "runs"), os.path.join(root, "tests")
    rng = np.random.default_rng(0)
    models = ["llava-hf/llava-1.5-7b-hf", "Qwen/Qwen2-VL-2B-Instruct"]
    for exp, staged in (("cross_A", True), ("single_qwen_B", False), ("empty_C", None)):
        d = os.path.join(runs, exp)
        os.makedirs(d)
        if staged is None:
            continue
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"num_iterations": 20, "epsilon": 0.4,
                       ("model_names" if staged else "model_name"): models if staged else models[1]}, f)
        for it in (1, 11, 21):
            _png(os.path.join(d, f"optimized_image_iter_{it}.png"), it)
        for it in (0, 10, 20):
            rows = [[f"question {q}, with a comma", *[f"answer {q} of {m}\n{'sure' if (q + it) % 3 else ''}"
                                                      for m in models]] for q in range(4)]
            _csv(os.path.join(d, f"test_results_iter_{it}.csv"), ["question", *models], rows)
        if staged:
            jd = os.path.join(d, "safety_details", JUDGE)
            os.makedirs(jd)
            for it in (0, 10):
                rows = [[f"q{q}", m, f"text; {q}", bool(rng.random() < 0.5), "x"] for q in range(5) for m in models]
                for r in rows:
                    r[4] = "safe" if r[3] else "unsafe"
                _csv(os.path.join(jd, f"safety_details_iter_{it}.csv"),
                     ["question", "model", "text_answer", "is_safe", "safety_status"], rows, sep=";")
            with open(os.path.join(d, "best.txt"), "w") as f:
                f.write("10\n")
            _csv(os.path.join(d, "unsafe_metrics_models.csv"), ["iteration", *models, "ALL_MODELS_MEAN"],
                 [[0, 0.4, 0.6, 0.5], [10, 0.2, 0.8, 0.5]])
    for name, n_cat, mean in (("cross_A_10", 23, "0.375\n"), ("cross_A_0", 5, "not a number"),
                              ("single_qwen_B_20", 23, None), ("notastep", 1, None)):
        for suf in ("llava-hf", "Qwen"):
            md = os.path.join(tests, name, suf)
            os.makedirs(md)
            for c in range(1, n_cat + 1):
                _csv(os.path.join(md, f"{c}.csv"), None, [[f"gen {c}, {i}"] for i in range(3)] + [[""]])
            if mean is not None and suf == "Qwen":
                with open(os.path.join(md, "mean_result_gemma.txt"), "w") as f:
                    f.write(mean)
                _csv(os.path.join(md, "results_gemma.csv"), ["category", "asr"], [[c, c / 23] for c in range(1, 4)])
                _csv(os.path.join(md, "guard_gemma.csv"), ["1", "2"], [[True, False], [False, False]])
    return runs, tests


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("post"))
    runs, tests = fabricate_trees(root)
    return tracker.ExperimentTracker(runs, tests), jtracker.ExperimentTracker(runs, tests)


def _records(df):
    return [] if df is None or df.empty else df.to_dict("records")


def _same(a, b):
    """Rows equal, numpy scalars compared as Python values; a missing value is NaN or None alike (a
    frame turns None into NaN in a column that holds numbers, the rows keep None). Floats agree to
    1e-15 relative: pandas' default C parser can round a 17-digit float one unit off the correctly
    rounded value Python's float() reads (0.043478260869565216 -> 0.0434782608695652)."""
    def norm(v):
        if isinstance(v, np.generic):
            v = v.item()
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return "missing"
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v

    ra = [{k: norm(v) for k, v in r.items()} for r in a]
    rb = [{k: norm(v) for k, v in r.items()} for r in b]
    assert [list(r) for r in ra] == [list(r) for r in rb]
    for x, y in zip(ra, rb):
        for k in x:
            if isinstance(x[k], float) and isinstance(y[k], float):
                assert math.isclose(x[k], y[k], rel_tol=1e-15), (k, x[k], y[k])
            else:
                assert x[k] == y[k], (k, x[k], y[k])
    assert len(ra) == len(rb)


def test_tracker_discovery_matches_jax(trees):
    """Experiments, test runs, configs, saved and tested and judged iterations, regex search,
    best steps, the tests/ scan and each experiment's status equal the JAX tracker's."""
    ours, theirs = trees
    assert ours.list_experiments() == theirs.list_experiments() == ["cross_A", "empty_C", "single_qwen_B"]
    assert ours.list_test_runs() == theirs.list_test_runs()
    for exp in ours.list_experiments() + ["missing"]:
        for fn in ("get_config", "get_checkpoint_iterations", "get_available_test_steps", "get_judged_steps",
                   "get_best_step", "status"):
            assert getattr(ours, fn)(exp) == getattr(theirs, fn)(exp), (fn, exp)
    assert ours.get_checkpoint_iterations("cross_A") == [1, 11, 21]
    assert ours.find_experiments("QWEN|cross") == theirs.find_experiments("QWEN|cross") == ["cross_A", "single_qwen_B"]
    assert ours.scan_tests() == theirs.scan_tests()
    assert ours.scan_tests()["cross_A"][10]["models"]["Qwen"] == {"has_inference": True, "num_categories": 23,
                                                                  "asr": 0.375}


def test_tracker_tables_match_jax(trees):
    """Every table the JAX tracker returns as a DataFrame, as the port's rows: generations, safety
    details, the tests/ summary, SafeBench generations, guard results and verdicts, the unsafe
    metrics (its index column among the row's values), the per-model and per-step safety
    summaries, the runs summary and the runs with a best step."""
    ours, theirs = trees
    _same(ours.load_generations("cross_A", 10), _records(theirs.load_generations("cross_A", 10)))
    _same(ours.load_safety_details("cross_A", 0), _records(theirs.load_safety_details("cross_A", 0)))
    _same(ours.tests_summary(), _records(theirs.tests_summary()))
    _same(ours.load_safebench_generations("cross_A", 10, "Qwen", 2),
          _records(theirs.load_safebench_generations("cross_A", 10, "Qwen", 2)))
    assert ours.load_safebench_generations("cross_A", 10, "Qwen", 99) is None
    for fn in ("load_guard_results", "load_guard_verdicts"):
        _same(getattr(ours, fn)("cross_A", 10, "Qwen"), _records(getattr(theirs, fn)("cross_A", 10, "Qwen")))
        assert getattr(ours, fn)("cross_A", 10, "llava-hf") is None
    _same(ours.load_unsafe_metrics("cross_A"), theirs.load_unsafe_metrics("cross_A").reset_index().to_dict("records"))
    assert ours.load_unsafe_metrics("empty_C") is None
    for exp in ("cross_A", "single_qwen_B"):
        _same(ours.safety_summary(exp), _records(theirs.safety_summary(exp)))
        _same(ours.safety_step_summary(exp), _records(theirs.safety_step_summary(exp)))
    _same(ours.runs_summary(), _records(theirs.runs_summary()))
    _same(ours.runs_with_best_steps(), _records(theirs.runs_with_best_steps()))
    assert [r["experiment"] for r in ours.runs_with_best_steps()] == ["cross_A"]


def test_plot_asr_dynamics_writes_the_png(trees, tmp_path):
    """plot_asr_dynamics draws one line a model over the judged iterations into a PNG (matplotlib
    imported lazily, as in the JAX package) and returns None for an experiment without judging."""
    ours, _ = trees
    out = ours.plot_asr_dynamics("cross_A", out_path=str(tmp_path / "asr.png"))
    assert out == str(tmp_path / "asr.png") and os.path.getsize(out) > 0
    assert ours.plot_asr_dynamics("single_qwen_B") is None


class _Victim:
    def __init__(self, name):
        self.name, self.bundle, self.adv_inputs, self.adv_processor = name, None, None, None
        self.compute_dtype = None


def _fake_run_model_test(**kw):
    """Numbers of the image and the iteration (both packages get this rule): floats whose shortest
    repr has many digits, and an int."""
    img = np.asarray(kw["image_chw"], np.float64)
    it = kw["iteration"]
    log = {"test_target_first_word_acc": float(img.mean()), "test_target_acc": it / 7,
           "test_refuse_count": float(len(kw["not_safe_questions_test"])), "test_total_questions": 1.0}
    return None, log


@pytest.mark.parametrize("offset", [0, 1])
def test_summary_csv_bytes_match_jax(tmp_path, monkeypatch, offset):
    """test_adversarial_images over iterations with a saved image, one whose image is missing
    (skipped) and one whose PNG is corrupt (skipped as unreadable): the same summary.csv bytes as
    the JAX module's, at image-index offsets 0 and 1 (gen_ans_for_steps' +1)."""
    runs = str(tmp_path / "runs")
    d = os.path.join(runs, "exp")
    os.makedirs(d)
    for it in (2, 5):
        _png(os.path.join(d, f"optimized_image_iter_{it}.png"), 100 + it)
    with open(os.path.join(d, "optimized_image_iter_7.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot a png at all")
    monkeypatch.setattr(jpost, "run_model_test", _fake_run_model_test)
    monkeypatch.setattr(post, "run_model_test", _fake_run_model_test)
    its = [i - offset for i in (2, 3, 5, 7)]
    qs = ["q1", "q2", "q3"]
    out_j = jpost.test_adversarial_images([_Victim("m")], "exp", its, qs, question_set_name="jax", runs_path=runs,
                                          image_index_offset=offset)
    out_t = post.test_adversarial_images([_Victim("m")], "exp", its, qs, question_set_name="port", runs_path=runs,
                                         image_index_offset=offset)
    got = open(os.path.join(out_t, "summary.csv"), "rb").read()
    assert got == open(os.path.join(out_j, "summary.csv"), "rb").read()
    assert got.count(b"\n") == 3  # the header and the two readable images
    empty_j = jpost.test_adversarial_images([_Victim("m")], "exp", [40], qs, question_set_name="jax0", runs_path=runs)
    empty_t = post.test_adversarial_images([_Victim("m")], "exp", [40], qs, question_set_name="port0", runs_path=runs)
    assert open(os.path.join(empty_t, "summary.csv"), "rb").read() == \
        open(os.path.join(empty_j, "summary.csv"), "rb").read()


def test_gen_answers_for_steps_matches_jax(trees, monkeypatch, tmp_path):
    """gen_answers_for_steps re-tests every judged step (else every test step) at the +1 image
    offset, with the same summary.csv bytes as the JAX package's; an experiment without steps is
    skipped."""
    ours, _ = trees
    monkeypatch.setattr(jpost, "run_model_test", _fake_run_model_test)
    monkeypatch.setattr(post, "run_model_test", _fake_run_model_test)
    exps = ["cross_A", "single_qwen_B", "empty_C"]
    jpost.gen_answers_for_steps([_Victim("m")], exps, ["q"], question_set_name="jax", runs_path=ours.runs_path,
                                tests_path=ours.tests_path)
    post.gen_answers_for_steps([_Victim("m")], exps, ["q"], question_set_name="port", runs_path=ours.runs_path,
                               tests_path=ours.tests_path)
    for exp in exps[:2]:
        base = os.path.join(ours.runs_path, exp, "post_test_results")
        got = open(os.path.join(base, "port", "summary.csv"), "rb").read()
        assert got == open(os.path.join(base, "jax", "summary.csv"), "rb").read()
    assert open(os.path.join(ours.runs_path, "cross_A", "post_test_results", "port", "summary.csv"),
                "rb").read().startswith(b"iteration,test_target_first_word_acc")
    assert not os.path.exists(os.path.join(ours.runs_path, "empty_C", "post_test_results"))


def test_cli_retests_a_tiny_qwen_run(tmp_path, capsys):
    """cli/test_post.py on the CPU with tiny:qwen2vl over a run's saved 56×84 images: a questions
    file with a header and a comma in a question, two iterations: each iteration's CSV (a row a
    question) and a summary row each; a run without images exits naming it; an mllama name without
    a directory stops at "no local checkpoint", and tiny:mllama re-tests the run."""
    runs = str(tmp_path / "runs")
    d = os.path.join(runs, "exp")
    os.makedirs(d)
    for it in (1, 3):
        _png(os.path.join(d, f"optimized_image_iter_{it}.png"), it, hw=(56, 84))
    qf = tmp_path / "q.csv"
    qf.write_text("question\nWhat is it, exactly?\n\nWhy?\n")
    assert cli.read_questions(str(qf)) == ["What is it, exactly?", "Why?"]
    out = cli.main(["--exp", "exp", "--model_name", "tiny:qwen2vl", "--runs_path", runs, "--questions_file",
                    str(qf), "--question_set_name", "mine", "--max_new_tokens", "4", "--device", "cpu"])
    assert out == os.path.join(d, "post_test_results", "mine")
    from adversarialvlm_tpu_torch.eval.tables import read_rows

    summary = read_rows(os.path.join(out, "summary.csv"))
    assert [r["iteration"] for r in summary] == [1, 3]
    for it in (1, 3):
        rows = read_rows(os.path.join(out, f"test_results_iter_{it}.csv"))
        assert [r["question"] for r in rows] == ["What is it, exactly?", "Why?"]
        assert list(rows[0]) == ["question", "tiny:qwen2vl"]
    assert "generate_programs: configs=1 programs=1" in capsys.readouterr().out
    os.makedirs(os.path.join(runs, "bare"))
    with pytest.raises(SystemExit, match="no checkpoint iterations"):
        cli.main(["--exp", "bare", "--model_name", "tiny:qwen2vl", "--runs_path", runs, "--device", "cpu"])
    # the mllama names resolve to their family since it was ported: without a directory, "no local
    # checkpoint"; tiny:mllama re-tests the same run
    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
        cli.main(["--exp", "exp", "--model_name", "alpindale/Llama-3.2-11B-Vision-Instruct", "--runs_path", runs,
                  "--checkpoint_root", str(tmp_path / "none"), "--device", "cpu"])
    out = cli.main(["--exp", "exp", "--model_name", "tiny:mllama", "--runs_path", runs, "--questions_file",
                    str(qf), "--question_set_name", "mllama", "--max_new_tokens", "4", "--device", "cpu"])
    assert [r["iteration"] for r in read_rows(os.path.join(out, "summary.csv"))] == [1, 3]
    assert list(read_rows(os.path.join(out, "test_results_iter_3.csv"))[0]) == ["question", "tiny:mllama"]
