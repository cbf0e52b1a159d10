"""SafeBench runner. Counterpart of adversarialvlm_tpu/eval/safebench.py (the reference's
src/evaluation/SafeBench_universal.py).

Loads the experiment's optimized image at iteration + 1 (the reference's off-by-one index,
SafeBench_universal.py:36) through utils/png.py, generates greedy answers (max 128 / min 32 new
tokens) to each of SafeBench's 23 question CSVs with the adversarial image attached, and writes
``tests/<exp>_<iter>/<suf>/{i}.csv`` as pandas would (eval/tables.py).
"""

from __future__ import annotations

import os

from adversarialvlm_tpu_torch.eval.generation import generate_answers
from adversarialvlm_tpu_torch.eval.tables import read_column, write_table
from adversarialvlm_tpu_torch.ops.image import from_pil_array
from adversarialvlm_tpu_torch.utils.png import read_png

# model-suffix map (SafeBench_universal.py:19-24; shared by MM-SafetyBench and FigStep in the
# reference)
DICT_SUF_MODELNAME = {
    "qwenVL": "Qwen/Qwen2-VL-2B-Instruct",
    "phi35": "microsoft/Phi-3.5-vision-instruct",
    "Llama32": "alpindale/Llama-3.2-11B-Vision-Instruct",
    "llava-hf": "llava-hf/llava-1.5-7b-hf",
}

N_CATEGORIES = 23


def load_safebench_questions(sfb_path: str, category: int) -> list[str]:
    """The questions of ``<sfb_path>/<category>.csv`` (one per line, no header); an empty cell
    reads as "nan", as through pandas."""
    return [str(x) for x in read_column(os.path.join(sfb_path, f"{category}.csv"))]


def optimized_image_path(runs_root: str, exp: str, iteration: int) -> str:
    """The image SafeBench attaches for ``iteration``: the one saved at ``iteration + 1``."""
    return os.path.join(runs_root, exp, f"optimized_image_iter_{iteration + 1}.png")


def run_safebench(
    victim,
    exp: str,
    iteration: int,
    sfb_path: str,
    runs_root: str = "./runs",
    tests_root: str = "./tests",
    model_suf: str | None = None,
    max_new_tokens: int = 128,
    min_new_tokens: int = 32,
    batch_size: int = 8,
    categories=None,
) -> str:
    """Returns the output directory tests/<exp>_<iter>/<suf>."""
    model_suf = model_suf or victim.name.split("/")[-1]
    image_path = optimized_image_path(runs_root, exp, iteration)
    if not os.path.exists(image_path):
        raise FileNotFoundError(f"ERROR, image doesn't exist: {image_path}")
    image = from_pil_array(read_png(image_path))

    out_dir = os.path.join(tests_root, f"{exp}_{iteration}", model_suf)
    os.makedirs(out_dir, exist_ok=True)

    for i in categories or range(1, N_CATEGORIES + 1):
        questions = load_safebench_questions(sfb_path, i)
        answers = generate_answers(
            victim,
            questions,
            image_chw=image,
            max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens,
            batch_size=batch_size,
        )
        write_table(os.path.join(out_dir, f"{i}.csv"), None, [[a] for a in answers])
    return out_dir
