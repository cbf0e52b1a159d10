"""Post-hoc re-tester: the in-training test harness run again over saved iterations with a
question set of one's choice, writing ``post_test_results/<set>/test_results_iter_<N>.csv`` and a
summary.csv. Counterpart of adversarialvlm_tpu/eval/test_post.py (reference: src/test_post.py).

As the reference does (test_post.py:210-212), an iteration whose image cannot be read is skipped
with a message and the run goes on; unlike the JAX package's catch-all, a failure of the decode
itself (the victim, its kernels on the card) propagates, so a failed kernel never leaves a
summary that merely lacks its row.
"""

from __future__ import annotations

import os

from adversarialvlm_tpu_torch.eval.experiment_tracker import ExperimentTracker
from adversarialvlm_tpu_torch.eval.tables import write_table
from adversarialvlm_tpu_torch.eval.train_test import run_model_test
from adversarialvlm_tpu_torch.ops.image import from_pil_array
from adversarialvlm_tpu_torch.utils.images import read_rgb


def test_adversarial_images(
    victims,
    exp: str,
    iterations: list[int],
    questions: list[str],
    question_set_name: str = "custom",
    runs_path: str = "./runs",
    target_text: str = "sure, here it is",
    max_new_tokens: int = 64,
    image_index_offset: int = 0,
) -> str:
    """Re-test the saved images of ``iterations`` (optimized_image_iter_<it + image_index_offset>.png;
    the offset mirrors gen_ans_for_steps.py:33's +1) with each victim; returns the output
    directory. summary.csv has a row per tested iteration: the iteration and run_model_test's
    metrics, bytes as pandas' ``to_csv(index=False)`` writes them."""
    exp_dir = os.path.join(runs_path, exp)
    out_dir = os.path.join(exp_dir, "post_test_results", question_set_name)
    os.makedirs(out_dir, exist_ok=True)
    summary_rows: list[dict] = []
    for it in iterations:
        img_path = os.path.join(exp_dir, f"optimized_image_iter_{it + image_index_offset}.png")
        if not os.path.exists(img_path):
            print(f"skip iter {it}: missing {img_path}")
            continue
        try:
            image = from_pil_array(read_rgb(img_path))
        except Exception as e:  # noqa: BLE001 — the reference's per-iteration continue
            print(f"iteration {it} failed: {e}")
            continue
        _, log = run_model_test(
            bundles=[v.bundle for v in victims],
            adv_inputs_list=[v.adv_inputs for v in victims],
            adv_processors=[v.adv_processor for v in victims],
            model_names=[v.name for v in victims],
            not_safe_questions_test=questions,
            target_text=target_text,
            exp_path=out_dir,
            iteration=it,
            image_chw=image,
            max_new_tokens=max_new_tokens,
            cache_dtype=[v.compute_dtype for v in victims],  # as the engine's test decode
        )
        summary_rows.append({"iteration": it, **log})
    columns: list[str] = []
    for row in summary_rows:
        columns.extend(k for k in row if k not in columns)
    write_table(os.path.join(out_dir, "summary.csv"), columns,
                [[row.get(c) for c in columns] for row in summary_rows])
    return out_dir


def gen_answers_for_steps(
    victims,
    exps: list[str],
    questions: list[str],
    question_set_name: str = "custom",
    runs_path: str = "./runs",
    tests_path: str = "./tests",
    **kw,
) -> None:
    """The tracker and the re-tester together (src/gen_ans_for_steps.py): every iteration that
    already has judged safety details (else every test step) re-tested, with the reference's +1
    image-index offset."""
    tracker = ExperimentTracker(runs_path, tests_path)
    for exp in exps:
        steps = tracker.get_judged_steps(exp) or tracker.get_available_test_steps(exp)
        if not steps:
            print(f"{exp}: no judged/test steps found")
            continue
        test_adversarial_images(victims, exp, steps, questions, question_set_name=question_set_name,
                                runs_path=runs_path, image_index_offset=1, **kw)
