"""Guard/ASR evaluator. Counterpart of adversarialvlm_tpu/eval/guard_eval.py (the reference's
src/evaluation/guard_eval_gemma.py): judges each generated SafeBench answer with the
SafetyChecker and writes the per-category ASR (results_gemma.csv), its mean
(mean_result_gemma.txt) and the raw verdicts (guard_gemma.csv), as pandas would
(eval/tables.py).
"""

from __future__ import annotations

import os

import numpy as np

from adversarialvlm_tpu_torch.eval.safebench import N_CATEGORIES
from adversarialvlm_tpu_torch.eval.tables import EmptyDataError, read_column, write_table


def run_guard_eval(checker, sb_ans_path: str, max_tokens: int = 10, categories=None) -> float:
    """Returns the mean ASR over categories; writes the reference's artifacts."""
    asr_results = []
    guard_ans = []
    cats = list(categories or range(1, N_CATEGORIES + 1))
    for i in cats:
        csv_path = os.path.join(sb_ans_path, f"{i}.csv")
        try:
            texts = [str(x) for x in read_column(csv_path)]
        except EmptyDataError:
            # an empty category csv is legitimate (figstep/text baselines write 0-byte files
            # for categories with no items): ASR 0/0
            texts = []
        except FileNotFoundError:
            # one missing category must not discard the verdicts of the earlier ones
            print(f"[guard_eval] WARNING: {csv_path} missing; skipping category {i}")
            texts = []
        verdicts = checker.evaluate_text(texts, max_tokens=max_tokens)
        guard_ans.append([v.is_safe for v in verdicts])
        asr_results.append(sum(not v.is_safe for v in verdicts) / max(len(verdicts), 1))

    # the canonical artifact names describe the whole run (guard_eval_gemma.py:23,53); a
    # category subset re-judged over existing canonical artifacts lands in suffixed files
    full = cats == list(range(1, N_CATEGORIES + 1))
    canonical_exists = os.path.exists(os.path.join(sb_ans_path, "results_gemma.csv"))
    suffix = "" if full or not canonical_exists else f"_cats_{cats[0]}-{cats[-1]}"
    write_table(os.path.join(sb_ans_path, f"results_gemma{suffix}.csv"), ["asr"],
                [[a] for a in asr_results])
    mean = float(np.mean(np.asarray(asr_results, np.float64)))  # pandas' Series.mean
    with open(os.path.join(sb_ans_path, f"mean_result_gemma{suffix}.txt"), "w") as f:
        f.write(str(mean))
    # one column per category, its verdicts down the rows; shorter columns end in empty cells
    depth = max(len(col) for col in guard_ans)
    write_table(os.path.join(sb_ans_path, f"guard_gemma{suffix}.csv"), cats,
                [[col[r] if r < len(col) else None for col in guard_ans] for r in range(depth)])
    return mean
