"""MM-SafetyBench baseline. Counterpart of adversarialvlm_tpu/eval/mm_safetybench.py (the
reference's src/evaluation/MM_SafetyBench_baseline.py): a victim answers MM-SafetyBench's SD, TYPO
or SD_TYPO images with their rephrased questions; one CSV of answers per category. When a
category's batched path fails, each image is answered alone and a failing image's row reads
``ERROR: <message>`` (MM_SafetyBench_baseline.py:140-142).
"""

from __future__ import annotations

import glob
import json
import os

from adversarialvlm_tpu_torch.eval.generation import (
    eval_target_hw,
    generate_answers,
    generate_answers_per_image,
    load_images_bucketed,
)
from adversarialvlm_tpu_torch.eval.tables import write_table
from adversarialvlm_tpu_torch.ops.image import from_pil_array
from adversarialvlm_tpu_torch.utils.images import read_rgb, resize_bilinear

IMAGE_TYPES = ("SD", "TYPO", "SD_TYPO")

# how many categories took the batched path, and how many fell back to one image at a time
PATH_COUNTS = {"batched": 0, "per_image": 0}


def run_mm_safetybench(
    victim,
    dataset_root: str,
    result_dir: str,
    image_type: str = "SD_TYPO",
    max_new_tokens: int = 128,
    min_new_tokens: int = 32,
    batch_size: int = 4,
) -> None:
    """``dataset_root`` holds ``images/<category>/<image_type>/<id>.(png|jpg)`` and
    ``text/<category>.json`` mapping each id to its questions (``Rephrased Question(SD)`` for the
    SD images, else ``Rephrased Question``)."""
    assert image_type in IMAGE_TYPES, f"image_type must be one of {IMAGE_TYPES}"
    os.makedirs(result_dir, exist_ok=True)
    category_dirs = sorted(
        (d for d in glob.glob(os.path.join(dataset_root, "images", "*"))
         if os.path.isdir(d) and os.path.basename(d).isdigit()),
        key=lambda x: int(os.path.basename(x)),
    )
    prompt_key = "Rephrased Question(SD)" if image_type == "SD" else "Rephrased Question"
    for category_dir in category_dirs:
        category_id = os.path.basename(category_dir)
        json_file = os.path.join(dataset_root, "text", f"{category_id}.json")
        if not os.path.exists(json_file):
            print(f"Warning: Text file for category {category_id} not found. Skipping.")
            continue
        with open(json_file) as f:
            question_data = json.load(f)
        image_files = sorted(glob.glob(os.path.join(category_dir, image_type, "*")), key=os.path.basename)
        files, prompts = [], []
        for image_file in image_files:
            entry = question_data.get(os.path.splitext(os.path.basename(image_file))[0])
            if entry is None:
                continue
            files.append(image_file)
            prompts.append(entry.get(prompt_key) or entry.get("Rephrased Question", "Describe this image."))

        responses = [None] * len(files)
        try:
            images, _ = load_images_bucketed(files, target_hw=eval_target_hw(victim))
            responses = list(generate_answers_per_image(
                victim, prompts, images, max_new_tokens=max_new_tokens,
                min_new_tokens=min_new_tokens, batch_size=batch_size,
            ))
            PATH_COUNTS["batched"] += 1
        except Exception as batch_err:
            # the reference's ERROR-row granularity, saying why the batched path died
            print(f"[mm_safetybench] batched path failed for category {category_id}/{image_type} "
                  f"({batch_err!r}); falling back to per-image generation")
            PATH_COUNTS["per_image"] += 1
            target = eval_target_hw(victim)
            for j, (image_file, prompt) in enumerate(zip(files, prompts)):
                try:
                    img = read_rgb(image_file)
                    if target is not None and img.shape[:2] != tuple(target):
                        img = resize_bilinear(img, target)
                    (responses[j],) = generate_answers(
                        victim, [prompt], image_chw=from_pil_array(img), max_new_tokens=max_new_tokens,
                        min_new_tokens=min_new_tokens, batch_size=batch_size,
                    )
                except Exception as e:
                    responses[j] = f"ERROR: {e}"
        write_table(os.path.join(result_dir, f"{category_id}.csv"), None, [[r] for r in responses])
