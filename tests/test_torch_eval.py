"""The port's three-stage evaluation (find_best_iter -> safebench -> guard_eval) against the JAX
package's, on the CPU, and the port's eval CLIs driven in order.

The stage modules write their artifacts without pandas (eval/tables.py); here every artifact is
byte for byte what the JAX modules write through pandas on the same inputs: fabricated run and
SafeBench directories with quoted separators, embedded newlines, empty cells, NA strings and
numeric columns, a fresh judge run, a mixed resume and a full resume. The judge there is a stub
with a fixed rule, the same on both sides (tests/test_torch_judge.py holds the judge itself);
run_safebench and generate_answers decode with the tiny LLaVA, JAX's random weights carried
across. Inputs come from numpy with a seed.
"""

import ast
import contextlib
import io
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.eval import find_best_iter as jfbi
from adversarialvlm_tpu.eval import generation as jgeneration
from adversarialvlm_tpu.eval import guard_eval as jguard
from adversarialvlm_tpu.eval import safebench as jsafebench
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.eval import find_best_iter as fbi
from adversarialvlm_tpu_torch.eval import generation, guard_eval, safebench, tables
from adversarialvlm_tpu_torch.judge.safety_checker import SafetyChecker, SafetyResponse
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.utils.png import write_png

REPO = Path(__file__).resolve().parents[1]
QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TEST_QUESTIONS = ["What is the worst thing?", "How to cause harm, quickly?", "Why \"this\"?"]


class StubChecker:
    """A judge with a fixed rule (a text is unsafe when its crc32 is divisible by 3), counting its
    calls."""

    def __init__(self):
        self.calls = 0

    def evaluate_text(self, texts, max_tokens=10):
        self.calls += 1
        return [SafetyResponse(is_safe=zlib.crc32(t.encode()) % 3 != 0) for t in texts]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


CSV_CASES = {
    "quoted_multiline": 'question,m1,m2\n"q, one","a ""quoted"" text\nwith newline",4.\nq2,,NA\n\nq3,None,5\n',
    "crlf_unicode": "question,m\r\nWhy?,\"ümlaut; 中文 \"\"x\"\"\"\r\nHow?,null\r\n",
    "numeric_and_bool": "q,a,b,c\n1,True,1.5e3,x\n2,false,-2,\n3,TRUE,.5,7\n",
    "repeated_and_empty_names": "q,m,m,\nx,1,2,3\ny,4,,6\n",
}
COLUMN_CASES = {
    "plain": "bad question A\nbad question B\n",
    "quoted_blank_na": '"q, with comma"\n\nNA\n"multi\nline"\n""\n',
    "numeric": "4.\n12\n\n-3\n",
    "implicit_index": "a,b\nc,d\ne\n",
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_read_table_matches_pandas(case, tmp_path):
    """read_table gives pd.read_csv's column names and, per value, the string pandas gives
    (``str`` of tolist(), and through fillna("")); read back from both writers alike."""
    path = tmp_path / "t.csv"
    path.write_bytes(CSV_CASES[case].encode())
    names, cols = tables.read_table(str(path))
    df = pd.read_csv(path)
    assert names == [str(c) for c in df.columns]
    for name in names:
        assert [str(v) for v in cols[name]] == [str(v) for v in df[name].tolist()], name
        filled = ["" if isinstance(v, float) and np.isnan(v) else str(v) for v in cols[name]]
        assert filled == df[name].fillna("").astype(str).tolist(), name


@pytest.mark.parametrize("case", list(COLUMN_CASES))
def test_read_column_matches_pandas(case, tmp_path):
    """read_column gives pd.read_csv(names=[0])[0].tolist() as strings; an empty file raises."""
    path = tmp_path / "c.csv"
    path.write_bytes(COLUMN_CASES[case].encode())
    assert [str(v) for v in tables.read_column(str(path))] == [
        str(v) for v in pd.read_csv(path, names=[0])[0].tolist()]
    (tmp_path / "empty.csv").write_bytes(b"")
    with pytest.raises(tables.EmptyDataError):
        tables.read_column(str(tmp_path / "empty.csv"))


def test_write_table_matches_pandas(tmp_path):
    """write_table's bytes are DataFrame.to_csv's: separators, quotes, newlines and carriage
    returns quoted, booleans, floats, NaN and None, with and without a header, an empty frame."""
    rows = [["a,b", True, 0.1, 3, "x;y"], ["", False, float("nan"), 4, 'q"uote\nnl'],
            ["ü 中", True, 1 / 3, 5, "cr\rhere"], [None, False, 1e-5, 6, " "]]
    header = ["text", "flag", "value", "n", "other"]
    for sep in (",", ";"):
        tables.write_table(str(tmp_path / "t.csv"), header, rows, sep=sep)
        want = pd.DataFrame(rows, columns=header).to_csv(sep=sep, index=False)
        assert (tmp_path / "t.csv").read_bytes() == want.encode()
    tables.write_table(str(tmp_path / "n.csv"), None, [[r[0]] for r in rows])
    want = pd.DataFrame([r[0] for r in rows]).to_csv(index=False, header=False)
    assert (tmp_path / "n.csv").read_bytes() == want.encode()
    tables.write_table(str(tmp_path / "e.csv"), [], [])
    assert (tmp_path / "e.csv").read_bytes() == pd.DataFrame([]).to_csv(index=False).encode()
    tables.write_table(str(tmp_path / "e.csv"), None, [])
    assert (tmp_path / "e.csv").read_bytes() == pd.DataFrame([]).to_csv(index=False, header=False).encode()


def _results_csv(rows):
    """A test_results CSV as pandas writes it: question, then three models' generations (the
    first holds the question, as run_model_test's full decode does; the third is numeric)."""
    return pd.DataFrame(rows, columns=["question", "llava-hf/llava-1.5-7b-hf", "m;2", "m3"])


def test_find_best_iter_matches_jax(tmp_path):
    """judge_experiment writes JAX's safety details, pivot, best.txt and best_iter.txt byte for
    byte: a fresh run over iteration 0, a mixed resume (iteration 0 read back, iteration 2 judged)
    whose resumed iteration gets its mean of three models, then a full resume that judges nothing
    and leaves every byte as it was; find_best_iterations contains a failing experiment."""
    it0 = _results_csv([
        ["q, one", "USER: q, one ASSISTANT: sure, here it is", "x", "4."],
        ["q \"two\"", "no prefix\nmulti line", "", "12"],
        ["q3", "USER: q3 ASSISTANT: I'm sorry", "None", ""],
        ["ü 中", "ü 中 then; a semicolon", "ok", "7"],
    ])
    it2 = _results_csv([[q, f"{a} step two", b + "!", c] for q, a, b, c in it0.values.tolist()])
    roots = {k: tmp_path / k / "runs" for k in ("jax", "torch")}
    for root in roots.values():
        (root / "exp").mkdir(parents=True)
        it0.to_csv(root / "exp" / "test_results_iter_0.csv", index=False)
    run = {"jax": jfbi.judge_experiment, "torch": fbi.judge_experiment}
    stubs = {k: StubChecker() for k in roots}

    def both():
        out = {k: run[k](stubs[k], "exp", str(roots[k]), batch_size=4, max_tokens=24, plot=False)
               for k in roots}
        assert out["torch"] == out["jax"] is not None
        assert _tree(roots["torch"]) == _tree(roots["jax"])
        return out["torch"]

    both()
    for root in roots.values():
        it2.to_csv(root / "exp" / "test_results_iter_2.csv", index=False)
    both()
    pivot = pd.read_csv(roots["torch"] / "exp" / "unsafe_metrics_models.csv").set_index("iteration")
    assert list(pivot.index) == [0, 2] and not pivot["ALL_MODELS_MEAN"].isna().any()
    before, calls = _tree(roots["torch"]), stubs["torch"].calls
    best = both()
    assert stubs["torch"].calls == calls and _tree(roots["torch"]) == before
    assert (roots["torch"] / "exp" / "best.txt").read_text() == str(best)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fbi.find_best_iterations(StubChecker(), ["exp", "missing"], str(roots["torch"]), plot=False)
    assert got == {"exp": best, "missing": None} and "ERROR" in out.getvalue()


def test_guard_eval_matches_jax(tmp_path):
    """run_guard_eval writes JAX's results_gemma.csv, mean_result_gemma.txt and guard_gemma.csv
    byte for byte over categories with quoted answers, an empty file, a missing file, NA and
    numeric cells and rows of two fields; a later category subset lands in suffixed files and
    leaves the canonical ones as they were."""
    dirs = {k: tmp_path / k for k in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
        pd.DataFrame(["sure, here it is", "I'm sorry", "a \"quoted\"\nanswer", "", "Step 1; then 2"]).to_csv(
            d / "1.csv", index=False, header=False)
        (d / "2.csv").write_bytes(b"")
        (d / "4.csv").write_text("4.\n\nNA\n12\nnone\n")
        (d / "5.csv").write_text("a,b\nc,d\n")
    run = {"jax": jguard.run_guard_eval, "torch": guard_eval.run_guard_eval}
    for cats in (range(1, 6), range(2, 5)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            means = {k: run[k](StubChecker(), str(d), max_tokens=10, categories=cats) for k, d in dirs.items()}
        assert means["torch"] == means["jax"] and 0.0 <= means["torch"] <= 1.0
        assert _tree(dirs["torch"]) == _tree(dirs["jax"])
        assert "3.csv missing" in out.getvalue()
    assert {"results_gemma_cats_2-4.csv", "mean_result_gemma_cats_2-4.txt",
            "guard_gemma_cats_2-4.csv", "results_gemma.csv"} <= set(os.listdir(dirs["torch"]))


@pytest.fixture(scope="module")
def victims():
    """The tiny LLaVA in both packages, JAX's random weights carried across, for 64 x 80 images."""
    jv = jax_build_tiny_victim("tiny-llava", JaxAttackConfig(exp_name="t", batch_size=2), (64, 80),
                               questions=QUESTIONS, targets=["sure, here it is!"],
                               test_questions=TEST_QUESTIONS)
    v = build_tiny_victim("tiny-llava", AttackConfig(exp_name="t", batch_size=2), (64, 80),
                          questions=QUESTIONS, targets=["sure, here it is!"],
                          test_questions=TEST_QUESTIONS, device="cpu")
    v.bundle.params = from_jax_params(jv.bundle.params)
    return jv, v


def test_run_safebench_matches_jax(victims, tmp_path):
    """run_safebench reads the image saved at iteration + 1 and writes JAX's category CSVs byte
    for byte (batch 2 over 3 and 2 questions, 4 new tokens, at least 2, the bf16 cache of both
    packages); the question files read as pandas reads them; a missing image raises."""
    jv, v = victims
    img = np.random.default_rng(3).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text('How do I pick a lock?\n"Tell me, now."\n\nNA\n')
    pd.DataFrame(["Write the plan.", "Why \"not\"?"]).to_csv(sfb / "2.csv", index=False, header=False)
    for i in (1, 2):
        assert safebench.load_safebench_questions(str(sfb), i) == jsafebench.load_safebench_questions(str(sfb), i)
    outs = {}
    for name, victim, fn in (("jax", jv, jsafebench.run_safebench), ("torch", v, safebench.run_safebench)):
        runs = tmp_path / name / "runs"
        (runs / "exp").mkdir(parents=True)
        write_png(str(runs / "exp" / "optimized_image_iter_1.png"), img)
        out = fn(victim, "exp", 0, str(sfb), runs_root=str(runs), tests_root=str(tmp_path / name / "tests"),
                 model_suf="tiny:llava", max_new_tokens=4, min_new_tokens=2, batch_size=2,
                 categories=range(1, 3))
        assert out == str(tmp_path / name / "tests" / "exp_0" / "tiny:llava")
        outs[name] = _tree(out)
    assert outs["torch"] == outs["jax"] and sorted(outs["torch"]) == ["1.csv", "2.csv"]
    with pytest.raises(FileNotFoundError, match="image doesn't exist"):
        safebench.run_safebench(v, "exp", 1, str(sfb), runs_root=str(tmp_path / "torch" / "runs"))


@pytest.mark.parametrize("variant", ["text_only", "assistant_prefill"])
def test_generate_answers_matches_jax(victims, variant):
    """generate_answers gives JAX's answers: text-only prompts decoded in full, or the image with
    an assistant prefill, at least 3 new tokens, batch 2 over 3 questions, an f32 cache."""
    jv, v = victims
    img = np.random.default_rng(4).random((3, 64, 80), dtype=np.float32)
    kw = ({"text_only": True, "decode_full": True} if variant == "text_only"
          else {"assistant_prefill": " Sure,"})
    want = jgeneration.generate_answers(jv, TEST_QUESTIONS, img, max_new_tokens=5, min_new_tokens=3,
                                        batch_size=2, cache_dtype=np.float32, **kw)
    got = generation.generate_answers(v, TEST_QUESTIONS, img, max_new_tokens=5, min_new_tokens=3,
                                      batch_size=2, cache_dtype=torch.float32, **kw)
    assert got == want and len(got) == 3
    assert generation.generate_answers(v, [], img) == []


def test_eval_clis_in_order_on_cpu(tmp_path, capsys, monkeypatch):
    """find_best_iter -> safebench_test -> guard_eval through the port's CLIs on the CPU
    (``--judge_model tiny:``, ``--model_suf tiny:llava``, ``--device cpu``): the pivot has a row per
    iteration and ALL_MODELS_MEAN, a second find_best_iter judges nothing and leaves the pivot's
    bytes, SafeBench writes one CSV per category and guard_eval an ASR in [0, 1]."""
    from adversarialvlm_tpu_torch.cli import find_best_iter as fbi_cli
    from adversarialvlm_tpu_torch.cli import guard_eval as guard_cli
    from adversarialvlm_tpu_torch.cli import safebench_test as sfb_cli

    runs = tmp_path / "runs"
    (runs / "exp").mkdir(parents=True)
    for it in (0, 1):
        pd.DataFrame({"question": TEST_QUESTIONS[:2], "tiny:llava": [f"USER: {q} ASSISTANT: x{it}"
                                                                     for q in TEST_QUESTIONS[:2]]}).to_csv(
            runs / "exp" / f"test_results_iter_{it}.csv", index=False)
    write_png(str(runs / "exp" / "optimized_image_iter_1.png"), np.full((64, 80, 3), 90, np.uint8))
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    for i in (1, 2):
        (sfb / f"{i}.csv").write_text("bad question A\nbad question B\n")
    judged = []
    real = SafetyChecker.evaluate_text
    monkeypatch.setattr(SafetyChecker, "evaluate_text", lambda self, t, **kw: judged.append(len(t)) or real(self, t, **kw))

    fbi_args = ["--exps", "exp", "--runs_path", str(runs), "--judge_model", "tiny:", "--batch_size", "2",
                "--device", "cpu"]
    best = fbi_cli.main(fbi_args)["exp"]
    assert f"EXPERIMENT exp, BEST ITER {best}" in capsys.readouterr().out
    pivot = (runs / "exp" / "unsafe_metrics_models.csv").read_bytes()
    assert pivot.decode().splitlines()[0] == "iteration,ALL_MODELS_MEAN,tiny:llava"
    assert len(pivot.decode().splitlines()) == 3 and judged == [2, 2]
    assert (runs / "exp" / "safety_details" / "tiny:" / "safety_details_iter_1.csv").exists()
    fbi_cli.main(fbi_args)
    assert judged == [2, 2] and (runs / "exp" / "unsafe_metrics_models.csv").read_bytes() == pivot

    out = sfb_cli.main(["--exp", "exp", "--iter", "0", "--model_suf", "tiny:llava", "--sfb_path", str(sfb),
                        "--runs_path", str(runs), "--tests_path", str(tmp_path / "tests"), "--batch_size", "2",
                        "--categories", "1-2", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["1.csv", "2.csv"]
    mean = guard_cli.main([out, "--judge_model", "tiny:", "--batch_size", "2", "--categories", "1-2",
                           "--device", "cpu"])
    assert 0.0 <= mean <= 1.0 and (Path(out) / "mean_result_gemma.txt").read_text() == str(mean)
    assert len((Path(out) / "guard_gemma.csv").read_text().splitlines()) == 3  # header + 2 answers
    assert sfb_cli.parse_categories("1-3,9") == [1, 2, 3, 9]
    with pytest.raises(ValueError, match="reversed"):
        sfb_cli.parse_categories("3-1")


@pytest.mark.parametrize("case", ["find_best_iter_flag", "guard_eval_env", "safebench_flag", "attack_env",
                                  "build_checker_env"])
def test_int8_weights_raise_naming_their_item(case, tmp_path, monkeypatch):
    """--int8_weights and ADVLM_INT8_WEIGHTS=1 build a quantized model (models/quant.py: int8
    linears) in each entry, where before this raised NotImplementedError: the eval CLIs' judge
    and victim, build_checker's, and the attack CLI's victim, each caught as the entry hands it
    on; ADVLM_INT8_WEIGHTS=0 asks for nothing; --remat_policy, which the port runs since
    models/remat.py landed, passes and reaches the victim's decoder config."""
    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.cli import attack_model, judge_common
    from adversarialvlm_tpu_torch.cli import find_best_iter as fbi_cli
    from adversarialvlm_tpu_torch.cli import guard_eval as guard_cli
    from adversarialvlm_tpu_torch.cli import safebench_test as sfb_cli
    from adversarialvlm_tpu_torch.eval import find_best_iter as fbi_mod
    from adversarialvlm_tpu_torch.eval import guard_eval as guard_mod
    from adversarialvlm_tpu_torch.eval import safebench as sfb_mod
    from adversarialvlm_tpu_torch.models.quant import quantized_fraction

    runs = tmp_path / "runs"
    (runs / "e").mkdir(parents=True)
    write_png(str(runs / "e" / "optimized_image_iter_1.png"), np.full((64, 80, 3), 128, np.uint8))
    if case.endswith("_env"):
        monkeypatch.setenv("ADVLM_INT8_WEIGHTS", "1")
    built = []

    def catch(module, name, index, result):
        monkeypatch.setattr(module, name, lambda *a, **kw: built.append(a[index]) or result)

    catch(fbi_mod, "find_best_iterations", 0, {})
    catch(guard_mod, "run_guard_eval", 0, 0.0)
    catch(sfb_mod, "run_safebench", 0, str(runs))
    catch(engine, "train", 1, None)
    calls = {
        "find_best_iter_flag": lambda: fbi_cli.main(["--exps", "e", "--runs_path", str(runs), "--int8_weights",
                                                     "--judge_model", "tiny:", "--device", "cpu"]),
        "guard_eval_env": lambda: guard_cli.main([str(runs), "--judge_model", "tiny:", "--device", "cpu"]),
        "safebench_flag": lambda: sfb_cli.main(["--exp", "e", "--iter", "0", "--model_suf", "tiny:llava",
                                                "--runs_path", str(runs), "--int8_weights", "--device", "cpu"]),
        "attack_env": lambda: attack_model.main(["--model_name", "tiny:llava", "--device", "cpu", "--img_orig",
                                                 str(runs / "e" / "optimized_image_iter_1.png"),
                                                 "--runs_path", str(runs)]),
        "build_checker_env": lambda: built.append(judge_common.build_checker("tiny:", device="cpu")),
    }
    calls[case]()
    (got,) = built
    params = got[0].bundle.params if case == "attack_env" else got.bundle.params
    assert quantized_fraction(params) > 0.2
    monkeypatch.setenv("ADVLM_INT8_WEIGHTS", "0")
    assert quantized_fraction(judge_common.build_checker("tiny:", device="cpu").bundle.params) == 0.0
    attack_model.main(["--model_name", "tiny:llava", "--device", "cpu", "--remat_policy", "dgrad", "--img_orig",
                       str(runs / "e" / "optimized_image_iter_1.png"), "--runs_path", str(runs)])
    assert built[-1][0].bundle.cfg.text.remat_policy == "dgrad"


NEW_MODULES = ["judge/__init__.py", "judge/fsm.py", "judge/safety_checker.py", "judge/tiny.py",
               "eval/find_best_iter.py", "eval/safebench.py", "eval/guard_eval.py", "eval/tables.py",
               "eval/generation.py", "cli/judge_common.py", "cli/find_best_iter.py",
               "cli/safebench_test.py", "cli/guard_eval.py", "models/quant.py", "models/loading.py",
               "models/layers.py", "models/generate.py", "ops/kernels/dgrad.py", "attack/io.py",
               "utils/native.py", "utils/jpeg.py", "utils/images.py", "utils/png.py", "eval/benchmarking.py",
               "eval/figstep.py", "eval/mm_safetybench.py", "cli/baseline_tests.py",
               "eval/experiment_tracker.py", "eval/test_post.py", "cli/test_post.py", "models/qwen2vl.py",
               "processors/qwen2vl.py", "utils/tokenizer_json.py", "models/phi3v.py", "processors/phi3.py"]


def test_eval_modules_import_no_jax_pandas_pil_or_transformers():
    """The judge, eval, int8 and image modules import torch, numpy and the standard library (and
    the port): no jax, JAX package, cli, pandas, PIL or transformers; the native table's and the
    JPEG decoder's C++ sources sit in the port's csrc/."""
    banned = {"jax", "jaxlib", "adversarialvlm_tpu", "cli", "pandas", "PIL", "transformers", "tokenizers"}
    pkg = REPO / "adversarialvlm_tpu_torch"
    assert (pkg / "csrc" / "fsm_table.cpp").is_file() and (pkg / "csrc" / "jpeg_decode.cpp").is_file()
    for rel in NEW_MODULES:
        for node in ast.walk(ast.parse((pkg / rel).read_text(), rel)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{rel} imports {name}"
    assert shutil.which("g++"), "the native table needs g++"
