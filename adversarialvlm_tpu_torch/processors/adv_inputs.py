"""Attack input builder: the (targets × questions) prompt pool, tokenized once at setup into
left-padded host arrays, and the inference batches of the test decode. Counterpart of
adversarialvlm_tpu/processors/adv_inputs.py.

Row layout (static length L): [PAD ... prompt with expanded image tokens ... target ... extra].
Rows are left-padded, so the target suffix always occupies the final positions.
"""

from __future__ import annotations

import numpy as np

from adversarialvlm_tpu_torch.processors.prompts import PromptSpec


class AdvInputs:
    def __init__(
        self,
        spec: PromptSpec,
        tokenizer,
        questions: list[str],
        test_questions: list[str],
        batch_size: int,
        target_texts: list[str] | str,
        num_image_tokens: int,
        image_token_id: int,
        pad_token_id: int | None = None,
        image_expansion_ids: list[int] | None = None,
        refuse_texts: list[str] | None = None,
    ):
        self.spec = spec
        self.tokenizer = tokenizer
        self.questions = list(questions)
        self.test_questions = list(test_questions)
        self.batch_size = batch_size
        self.num_image_tokens = num_image_tokens
        self.image_token_id = image_token_id
        self.pad_token_id = pad_token_id if pad_token_id is not None else tokenizer.pad_token_id
        # the token expansion of the image placeholder: num_image_tokens image tokens, or the
        # family's framed form (gemma3: \n\n <boi> soft×256 <eoi> \n\n)
        self.image_expansion_ids = (
            list(image_expansion_ids) if image_expansion_ids is not None
            else [image_token_id] * num_image_tokens
        )
        self.target_texts = [target_texts] if isinstance(target_texts, str) else list(target_texts)
        # DPO (cross engine): the refusal texts are pool rows after the shared targets, so a
        # refusing step is a target index >= n_shared_targets (crossattack_models.py:302-310)
        self.refuse_texts = list(refuse_texts or [])
        self.n_shared_targets = len(self.target_texts)
        self.n_refuse = len(self.refuse_texts)
        self.shift = spec.shift(tokenizer)
        self._build_pools()

    def _encode_prompt(self, text: str) -> list[int]:
        """Tokenize, splicing the image expansion in where the placeholder was split out of the
        string (never by replacing a token id after a whole-string encode)."""
        ph = self.spec.image_placeholder
        parts = text.split(ph)
        if len(parts) == 1:
            return self.tokenizer.encode(text, add_special_tokens=self.spec.add_special_tokens)
        if not self.image_expansion_ids:
            raise ValueError(f"prompt contains {ph!r} but image_expansion_ids is empty: the "
                             "attack would see zero image tokens")
        out: list[int] = []
        for i, part in enumerate(parts):
            if part:
                out.extend(
                    self.tokenizer.encode(
                        part, add_special_tokens=self.spec.add_special_tokens and i == 0
                    )
                )
            elif i == 0 and self.spec.add_special_tokens:
                out.extend(self.tokenizer.encode("", add_special_tokens=True))
            if i < len(parts) - 1:
                out.extend(self.image_expansion_ids)
        return out

    def _scored_window(self, tail, per_q_rows, prefix_rows) -> list[int]:
        """``enc(target + extra)`` extended by any separator tokens the template puts between
        the generation tag and the target (a byte tokenizer emits the space on its own), so the
        window starts where generation starts. Falls back to ``tail`` unless every row is
        ``prefix + gap + tail`` with one gap."""
        gap: list[int] | None = None
        for full, prefix in zip(per_q_rows, prefix_rows):
            g = full[len(prefix) : len(full) - len(tail)]
            if (
                len(full) < len(prefix) + len(tail)
                or full[: len(prefix)] != prefix
                or full[len(full) - len(tail) :] != tail
                or (gap is not None and g != gap)
            ):
                return tail
            gap = g
        return (gap or []) + tail

    def _build_pools(self):
        pool_texts = self.target_texts + self.refuse_texts
        n_t, n_q = len(pool_texts), len(self.questions)
        prefix_rows = [self._encode_prompt(self.spec.inference_text(q)) for q in self.questions]
        rows: list[list[list[int]]] = []
        tgt_rows: list[list[int]] = []
        for t in pool_texts:
            tail = self.tokenizer.encode(t + self.spec.extra_token, add_special_tokens=False)
            per_q = [self._encode_prompt(self.spec.train_text(q, t)) for q in self.questions]
            tgt_rows.append(self._scored_window(tail, per_q, prefix_rows))
            rows.append(per_q)
        L = max(len(r) for per_t in rows for r in per_t)
        S = max(len(r) for r in tgt_rows)
        pool = np.full((n_t, n_q, L), self.pad_token_id, np.int32)
        lengths = np.zeros((n_t, n_q), np.int32)
        for i, per_t in enumerate(rows):
            for j, r in enumerate(per_t):
                pool[i, j, L - len(r) :] = r
                lengths[i, j] = len(r)
        targets = np.zeros((n_t, S), np.int32)
        target_mask = np.zeros((n_t, S), bool)
        suffix_lengths = np.zeros((n_t,), np.int32)
        for i, r in enumerate(tgt_rows):
            suffix_lengths[i] = len(r)
            targets[i, S - len(r) :] = r  # right-aligned; scored slots are [S-sl : S-shift]
            target_mask[i, S - len(r) : S - self.shift] = True
        self.prompt_pool = pool              # (N_t, N_q, L) left-padded
        self.prompt_lengths = lengths        # (N_t, N_q): attention masks derive from these
        self.target_pool = targets           # (N_t, S) right-aligned
        self.target_mask_pool = target_mask  # (N_t, S)
        self.suffix_lengths = suffix_lengths
        self.max_len = L
        self.target_width = S

    def get_inputs_inference_batch(
        self, batch_questions: list[str], text_only: bool = False, assistant_prefill: str = ""
    ) -> dict:
        """Left-padded inference batch {"input_ids", "attention_mask"} (B, L) int32 numpy;
        ``text_only`` drops the image span, ``assistant_prefill`` appends text after the
        generation tag."""

        def render(q):
            text = self.spec.inference_text(q)
            if text_only:
                text = text.replace(self.spec.image_span, "")
            return text + assistant_prefill

        rows = [self._encode_prompt(render(q)) for q in batch_questions]
        L = max(len(r) for r in rows)
        ids = np.full((len(rows), L), self.pad_token_id, np.int32)
        mask = np.zeros((len(rows), L), np.int32)
        for i, r in enumerate(rows):
            ids[i, L - len(r) :] = r
            mask[i, L - len(r) :] = 1
        return {"input_ids": ids, "attention_mask": mask}
