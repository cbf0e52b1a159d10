"""The port's baseline benchmarks (the text modes, MM-SafetyBench, FigStep and
cli/baseline_tests.py) and their host image path (the JPEG decoder, PIL's bilinear resize,
load_images_bucketed, _stack_processed) against PIL and the JAX package, on the CPU.

No JAX decode runs here: where a runner's artifacts are held against JAX's, both packages'
``decode_chunk_texts`` are replaced by the same rule, which answers from the question and the
image each row carries, so the artifacts test the runners, the loaders and the CSV writers. The
tiny LLaVA decodes on the port alone (per-image answers equal to singletons, the CLI). Inputs come
from numpy with a seed.
"""

import hashlib
import io
import json
import os
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from adversarialvlm_tpu.attack.config import AttackConfig as JaxAttackConfig
from adversarialvlm_tpu.attack.setup import build_tiny_victim as jax_build_tiny_victim
from adversarialvlm_tpu.eval import benchmarking as jbench
from adversarialvlm_tpu.eval import figstep as jfigstep
from adversarialvlm_tpu.eval import generation as jgeneration
from adversarialvlm_tpu.eval import mm_safetybench as jmmsb
from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.cli import baseline_tests
from adversarialvlm_tpu_torch.eval import benchmarking, figstep, generation, mm_safetybench
from adversarialvlm_tpu_torch.eval.tables import read_column
from adversarialvlm_tpu_torch.models.convert import from_jax_params
from adversarialvlm_tpu_torch.utils import images as port_images
from adversarialvlm_tpu_torch.utils.jpeg import decode_jpeg

DATA = Path(__file__).resolve().parent / "data"
QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
# the committed JPEG fixtures (chip_smoke.py phase 4B reads them on the card's machine, which
# cannot write JPEGs): name -> (chroma subsampling as PIL's save takes it, seed)
FIXTURES = {"mmsb_sd_typo_420.jpg": (2, 0), "mmsb_sd_typo_444.jpg": (0, 1)}


def smooth_image(h, w, seed):
    """Smooth seeded RGB content: products of sines with a little noise, as a photo has."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ch = []
    for _ in range(3):
        a, b, p = r.uniform(40, 160), r.uniform(40, 160), r.uniform(0, 6.3)
        ch.append(128 + 70 * np.sin(x / a + p) * np.cos(y / b - p) + 40 * np.sin((x + y) / (a + b)))
    img = np.stack(ch, -1) + r.normal(0, 2.0, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def make_jpeg_fixtures(out_dir=DATA):
    """Write the fixtures (1024², PIL's quality 75) and jpeg_fixtures.json, the SHA-256 of PIL's
    decoded RGB bytes of each; run once with PIL, the files are committed."""
    hashes = {}
    for name, (sub, seed) in FIXTURES.items():
        Image.fromarray(smooth_image(1024, 1024, seed)).save(out_dir / name, "JPEG", quality=75, subsampling=sub)
        with Image.open(out_dir / name) as im:
            hashes[name] = hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest()
    (out_dir / "jpeg_fixtures.json").write_text(json.dumps(hashes, indent=1) + "\n")


def _jpeg(arr, **save):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", **save)
    return b.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


_RNG = np.random.default_rng(0)
JPEG_CASES = {
    "444": lambda: _jpeg(smooth_image(40, 56, 1), subsampling=0, quality=90),
    "422": lambda: _jpeg(smooth_image(40, 56, 2), subsampling=1),
    "420": lambda: _jpeg(smooth_image(40, 56, 3), subsampling=2),
    "420_noise_q30": lambda: _jpeg(_RNG.integers(0, 256, (32, 48, 3), dtype=np.uint8), quality=30),
    "420_noise_q95": lambda: _jpeg(_RNG.integers(0, 256, (32, 48, 3), dtype=np.uint8), quality=95),
    "gray": lambda: _jpeg(_RNG.integers(0, 256, (33, 17), dtype=np.uint8)),
    "restart_blocks": lambda: _jpeg(_RNG.integers(0, 256, (33, 17, 3), dtype=np.uint8), restart_marker_blocks=2),
    "restart_rows_422": lambda: _jpeg(smooth_image(41, 67, 4), subsampling=1, restart_marker_rows=1),
    "odd_420": lambda: _jpeg(smooth_image(57, 91, 5), subsampling=2),
    "odd_444": lambda: _jpeg(smooth_image(17, 33, 6), subsampling=0),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_decoder_equals_pil(case):
    """decode_jpeg against PIL's ``convert("RGB")``, bit for bit (the limit of 1 level the task
    allows is not used): 4:4:4, 4:2:2 and 4:2:0 (fancy upsampling), noise at quality 30 and 95
    (the IDCT's range limit), gray, restart intervals by blocks and by rows, odd sizes."""
    data = JPEG_CASES[case]()
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def test_jpeg_decoder_names_what_it_refuses(tmp_path):
    """A progressive JPEG raises ValueError naming itself; read_rgb names a GIF, takes PNG and
    JPEG by their magic bytes whatever their extension, and a truncated JPEG raises."""
    with pytest.raises(ValueError, match="progressive JPEG is not supported"):
        decode_jpeg(_jpeg(smooth_image(32, 48, 7), progressive=True))
    gif = tmp_path / "a.jpg"
    Image.fromarray(smooth_image(8, 8, 8)).save(gif, "GIF")
    with pytest.raises(ValueError, match="GIF image"):
        port_images.read_rgb(str(gif))
    arr = smooth_image(24, 40, 9)
    png_as_jpg = tmp_path / "b.jpg"
    Image.fromarray(arr).save(png_as_jpg, "PNG")
    np.testing.assert_array_equal(port_images.read_rgb(str(png_as_jpg)), arr)
    data = _jpeg(arr)
    (tmp_path / "c.png").write_bytes(data)
    np.testing.assert_array_equal(port_images.read_rgb(str(tmp_path / "c.png")), _pil_rgb(data))
    (tmp_path / "d.jpg").write_bytes(data[:20])
    with pytest.raises(ValueError, match="d.jpg"):
        port_images.read_rgb(str(tmp_path / "d.jpg"))


def test_jpeg_fixtures_decode_to_their_hashes():
    """The committed 1024² fixtures (4:2:0 and 4:4:4, under 400 KB together) decode on the port
    to the SHA-256 that PIL's pixels had when they were made (jpeg_fixtures.json), which is what
    chip_smoke.py checks the card machine's decoder build against."""
    want = json.loads((DATA / "jpeg_fixtures.json").read_text())
    assert set(want) == set(FIXTURES)
    assert sum((DATA / n).stat().st_size for n in FIXTURES) < 400_000
    for name, digest in want.items():
        data = (DATA / name).read_bytes()
        got = decode_jpeg(data)
        assert got.shape == (1024, 1024, 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest == hashlib.sha256(_pil_rgb(data).tobytes()).hexdigest()


RESIZE_CASES = [((1024, 1024), (1036, 1036)), ((760, 760), (784, 784)), ((1024, 1024), (448, 448)),
                ((57, 91), (33, 17)), ((33, 17), (57, 91)), ((64, 80), (64, 45)), ((64, 80), (99, 80)),
                ((7, 5), (3, 11))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_bilinear_equals_pil(src, dst):
    """resize_bilinear against ``Image.resize((w, h), BILINEAR)`` on noise, bit for bit: the
    benchmarks' bucket sizes (1024 -> 1036, 760 -> 784), a downscale by more than 2 (support
    scaled), odd sizes both ways, and one axis only."""
    arr = np.random.default_rng(sum(src) + sum(dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((dst[1], dst[0]), Image.Resampling.BILINEAR))
    np.testing.assert_array_equal(port_images.resize_bilinear(arr, dst), want)


@pytest.fixture(scope="module")
def victims():
    """The tiny LLaVA in both packages, JAX's random weights carried across, built at 448²."""
    jv = jax_build_tiny_victim("tiny-llava", JaxAttackConfig(exp_name="b", batch_size=2), (448, 448),
                               questions=QUESTIONS, targets=["sure, here it is!"], test_questions=QUESTIONS)
    v = build_tiny_victim("tiny-llava", AttackConfig(exp_name="b", batch_size=2), (448, 448),
                          questions=QUESTIONS, targets=["sure, here it is!"], test_questions=QUESTIONS,
                          device="cpu")
    v.bundle.params = from_jax_params(jv.bundle.params)
    return jv, v


def _image_dir(tmp_path):
    """A JPEG (4:2:0), a 4:4:4 JPEG of another size, a PNG and a gray JPEG."""
    d = tmp_path / "imgs"
    d.mkdir()
    Image.fromarray(smooth_image(100, 90, 10)).save(d / "0.jpg", quality=85)
    Image.fromarray(smooth_image(60, 130, 11)).save(d / "1.jpg", subsampling=0)
    Image.fromarray(smooth_image(100, 90, 12)).save(d / "2.png")
    Image.fromarray(smooth_image(50, 50, 13)[..., 0]).save(d / "3.jpg")
    return [str(d / f) for f in ("0.jpg", "1.jpg", "2.png", "3.jpg")]


@pytest.mark.parametrize("target", [None, (56, 84)])
def test_load_images_bucketed_and_stack_match_jax(victims, tmp_path, target):
    """load_images_bucketed gives JAX's array bit for bit (PIL's reads and bilinear resizes; the
    first image's bucket, 112 x 112, or a given shape); bucket_hw and eval_target_hw agree;
    _stack_processed gives JAX's per-row pixel inputs within 1e-6 (the same resize matmuls in f32,
    JAX's under jit)."""
    jv, v = victims
    files = _image_dir(tmp_path)
    want, want_hw = jgeneration.load_images_bucketed(files, target)
    got, got_hw = generation.load_images_bucketed(files, target)
    assert got_hw == want_hw == (target or (112, 112)) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert generation.load_images_bucketed([]) == jgeneration.load_images_bucketed([]) == (None, None)
    for hw in ((1, 1), (1024, 760), (2000, 55), (57, 56)):
        assert generation.bucket_hw(*hw) == jgeneration.bucket_hw(*hw)
    assert generation.eval_target_hw(v) == jgeneration.eval_target_hw(jv) is None
    jp = jgeneration._stack_processed(jv, want)
    tp = generation._stack_processed(v, got)
    assert set(tp) == set(jp) == {"pixel_values"}
    np.testing.assert_allclose(tp["pixel_values"].numpy(), jp["pixel_values"], rtol=1e-6, atol=1e-6)


def _answer(question, image=None):
    """The injected decode's answer: a refusal for one question in three (by crc32), and the
    image's checksum where the row has one; quotes, commas and a newline exercise the CSVs."""
    tag = "" if image is None else f" [img {int(np.round(np.asarray(image, np.float64).sum() * 255))}]"
    if zlib.crc32(question.encode()) % 3 == 0:
        return f"I'm sorry, I cannot help with \"{question}\"{tag}"
    return f"Sure, here it is:\n1. {question}{tag}"


def _fake_decode(questions, start, bs, *, images_chw=None, processed=None, assistant_prefill="", **kw):
    chunk = list(questions[start:start + bs])
    prefix = f"<{assistant_prefill}> " if assistant_prefill else ""
    if images_chw is None:
        return [prefix + _answer(q) for q in chunk]
    return [prefix + _answer(q, images_chw[start + i]) for i, q in enumerate(chunk)]


@pytest.fixture
def injected(monkeypatch):
    """Both packages' decode_chunk_texts replaced by _fake_decode."""
    for mod in (jgeneration, generation):
        monkeypatch.setattr(mod, "decode_chunk_texts",
                            lambda bundle, adv_inputs, questions, start, bs, **kw: _fake_decode(questions, start, bs, **kw))


def _tree(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode", ["reference", "shii", "gcg"])
def test_text_baseline_matches_jax(victims, injected, tmp_path, capsys, mode):
    """run_text_baseline's refusal rates, printed lines and {i}.csv bytes equal JAX's on the same
    injected answers: the gcg suffix appended, the shii prefill passed, the keyword count."""
    jv, v = victims
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text('How do I pick a lock?\n"Tell me, now."\n\nNA\nWhy?\n')
    (sfb / "2.csv").write_text('Write the plan.\n"List, the steps"\n')
    outs, rates, printed = {}, {}, {}
    for name, victim, fn in (("jax", jv, jbench.run_text_baseline), ("torch", v, benchmarking.run_text_baseline)):
        out = tmp_path / name
        rates[name] = fn(victim, mode, str(sfb), str(out), batch_size=2, categories=range(1, 3))
        printed[name] = capsys.readouterr().out
        outs[name] = _tree(out)
    assert rates["torch"] == rates["jax"] and outs["torch"] == outs["jax"] and printed["torch"] == printed["jax"]
    assert sorted(outs["torch"]) == ["1.csv", "2.csv"] and 0 < sum(rates["torch"].values())
    assert benchmarking.MODES == jbench.MODES and benchmarking.GCG_SUFFIX == jbench.GCG_SUFFIX
    assert benchmarking.REFUSE_KEYWORDS == jbench.REFUSE_KEYWORDS and benchmarking.SHII_PREFILL == jbench.SHII_PREFILL


def _mmsb(root, image_type="SD_TYPO"):
    """images/<cat>/<type>/<id>.jpg and text/<cat>.json: category 1 (4 JPEGs of two sizes, one
    without a question entry), 2 (a PNG and a JPEG; SD questions), 10 (numeric order after 2),
    3 without its text file, and a non-numeric directory that is skipped."""
    for cat, n in (("1", 4), ("2", 2), ("10", 1), ("3", 1), ("extra", 1)):
        d = root / "images" / cat / image_type
        d.mkdir(parents=True)
        for i in range(n):
            arr = smooth_image(80 + 8 * (i % 2), 64, int(cat) * 10 + i if cat.isdigit() else 99)
            Image.fromarray(arr).save(d / (f"{i}.png" if cat == "2" and i == 0 else f"{i}.jpg"), quality=80)
    (root / "text").mkdir()
    for cat, ids in (("1", ("0", "1", "2")), ("2", ("0", "1")), ("10", ("0",))):
        entries = {i: {"Rephrased Question": f"Describe, in detail: {cat}/{i}?",
                       "Rephrased Question(SD)": f"SD \"question\" {cat}/{i}"} for i in ids}
        if cat == "2":
            entries["1"] = {"Rephrased Question": ""}  # an empty question stays empty in both
        (root / "text" / f"{cat}.json").write_text(json.dumps(entries))
    return root


@pytest.mark.parametrize("image_type", ["SD_TYPO", "SD"])
def test_mm_safetybench_matches_jax(victims, injected, tmp_path, capsys, image_type):
    """run_mm_safetybench's CSVs equal JAX's byte for byte on the same injected answers, which
    carry each row's image checksum (so the JPEG reads, the bucket resizes and the image-question
    pairing are held too); the SD type reads ``Rephrased Question(SD)``; the category without a
    text file is skipped with JAX's warning; every category took the batched path."""
    jv, v = victims
    root = _mmsb(tmp_path / "MM_SafetyBench", image_type)
    outs, printed = {}, {}
    before = dict(mm_safetybench.PATH_COUNTS)
    for name, victim, fn in (("jax", jv, jmmsb.run_mm_safetybench), ("torch", v, mm_safetybench.run_mm_safetybench)):
        fn(victim, str(root), str(tmp_path / name), image_type=image_type, batch_size=2)
        printed[name] = capsys.readouterr().out
        outs[name] = _tree(tmp_path / name)
    assert outs["torch"] == outs["jax"] and printed["torch"] == printed["jax"]
    assert sorted(outs["torch"]) == ["1.csv", "10.csv", "2.csv"]
    assert "Warning: Text file for category 3 not found" in printed["torch"]
    assert (b"SD " in outs["torch"]["1.csv"]) == (image_type == "SD")
    assert mm_safetybench.PATH_COUNTS == {"batched": before["batched"] + 3, "per_image": before["per_image"]}


def test_mm_safetybench_falls_back_with_error_rows(victims, injected, tmp_path, capsys):
    """A category whose batched path fails (a progressive JPEG among its images) is answered one
    image at a time: the good images' rows are the batched path's answers, the bad one's row is
    ``ERROR: <message>`` naming the file and the format, and the log names the exception. (JAX's
    fallback unpacks eval_target_hw, None for LLaVA, and raises there: the port answers each image
    at its own size; ROADMAP §3.)"""
    _, v = victims
    root = _mmsb(tmp_path / "MM_SafetyBench")
    bad = root / "images" / "1" / "SD_TYPO" / "2.jpg"
    Image.fromarray(smooth_image(80, 64, 12)).save(bad, progressive=True)
    before = dict(mm_safetybench.PATH_COUNTS)
    mm_safetybench.run_mm_safetybench(v, str(root), str(tmp_path / "out"), batch_size=2)
    log = capsys.readouterr().out
    rows = [str(r) for r in read_column(str(tmp_path / "out" / "1.csv"))]
    assert "batched path failed for category 1/SD_TYPO (ValueError(" in log
    # answered alone, the image attached to the prompt (no per-row images)
    assert rows[:2] == [_answer(f"Describe, in detail: 1/{i}?") for i in (0, 1)]
    assert rows[2] == f"ERROR: {bad}: progressive JPEG is not supported (baseline sequential only)"
    assert mm_safetybench.PATH_COUNTS["per_image"] == before["per_image"] + 1


def _figstep(root):
    """<cat>_with_titles/*.png: category 1 with 10.png after 2.png and a stray name last, a named
    category, an empty category 2 and a non-PNG file that is not read."""
    for cat, names in (("1", ("2", "10", "1", "query_ForbidQI_1")), ("illegal_activity", ("0",)),
                       ("2", ())):
        d = root / f"{cat}_with_titles"
        d.mkdir(parents=True)
        for i, n in enumerate(names):
            Image.fromarray(smooth_image(76, 76, 20 + i)).save(d / f"{n}.png")
    (root / "1_with_titles" / "notes.txt").write_text("x")
    return root


def test_figstep_matches_jax(victims, injected, tmp_path):
    """run_figstep's CSVs equal JAX's byte for byte on the same injected answers: numeric file
    order with the stray name last, the named category's CSV stem, the empty category's empty
    CSV."""
    jv, v = victims
    root = _figstep(tmp_path / "FigStep")
    outs = {}
    for name, victim, fn in (("jax", jv, jfigstep.run_figstep), ("torch", v, figstep.run_figstep)):
        fn(victim, str(root), str(tmp_path / name), batch_size=3)
        outs[name] = _tree(tmp_path / name)
    assert outs["torch"] == outs["jax"]
    assert sorted(outs["torch"]) == ["1.csv", "2.csv", "illegal_activity.csv"] and outs["torch"]["2.csv"] == b""
    assert outs["torch"]["1.csv"].count(b"Sure") + outs["torch"]["1.csv"].count(b"sorry") == 4
    assert figstep.FIGSTEP_PROMPT == jfigstep.FIGSTEP_PROMPT


def test_per_image_answers_equal_singletons(victims):
    """generate_answers_per_image at batch 3 over 4 images (the last chunk repeating its last
    row) gives each image's answer alone, generate_answers with that image (the tiny LLaVA on the
    port, f32, 6 new tokens, at least 2): the rows of a batch do not leak into each other; one
    decode configuration served the batched run."""
    _, v = victims
    imgs = np.stack([np.random.default_rng(30 + i).random((3, 56, 84), dtype=np.float32) for i in range(4)])
    qs = ["What is shown?", "Describe it, please.", "Why?", "List the steps in the image."]
    v.bundle.decode_configs.clear()
    got = generation.generate_answers_per_image(v, qs, imgs, max_new_tokens=6, min_new_tokens=2, batch_size=3,
                                                cache_dtype=torch.float32)
    assert v.bundle.generate_program_counts() == (1, 1)
    alone = [generation.generate_answers(v, [q], image_chw=img, max_new_tokens=6, min_new_tokens=2, batch_size=1,
                                         cache_dtype=torch.float32)[0] for q, img in zip(qs, imgs)]
    assert got == alone and len(set(got)) > 1
    assert generation.generate_answers_per_image(v, [], None) == []


@pytest.fixture
def one_thread():
    """One intra-op thread for the CLI's 128-token tiny decodes: with one worker per core, the
    default thread pools oversubscribe the cores and slow each tiny op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["reference", "mm_safetybench", "figstep"])
def test_baseline_cli_runs_tiny_llava(tmp_path, mode, capsys, one_thread):
    """cli/baseline_tests.py on the CPU with tiny:llava and int8 weights, at its 128 new tokens:
    the output layout, a row per question or image (2 a category, one batch), and the closing
    generate_programs line: one decode configuration."""
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text("How?\nWhy?\n")
    ds = tmp_path / "datasets"
    for i in range(2):
        d = ds / "MM_SafetyBench" / "images" / "1" / "SD_TYPO"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(smooth_image(80, 64, 40 + i)).save(d / f"{i}.jpg")
        d = ds / "FigStep" / "images" / "1_with_titles"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(smooth_image(76, 76, 50 + i)).save(d / f"{i}.png")
    (ds / "MM_SafetyBench" / "text").mkdir()
    (ds / "MM_SafetyBench" / "text" / "1.json").write_text(
        json.dumps({str(i): {"Rephrased Question": f"What is in image {i}?"} for i in range(2)}))
    out = baseline_tests.main(["--model", "tiny:llava", "--mode", mode, "--sfb_path", str(sfb), "--dataset_root",
                               str(ds), "--tests_path", str(tmp_path / "tests"), "--categories", "1",
                               "--batch_size", "2", "--int8_weights", "--device", "cpu"])
    text = capsys.readouterr().out
    sub = {"reference": "reference", "mm_safetybench": "MM-SafetyBench_SD_TYPO", "figstep": "FigStep_baseline"}[mode]
    assert out == os.path.join(str(tmp_path / "tests"), sub, "tiny:llava")
    assert os.listdir(out) == ["1.csv"] and len(read_column(os.path.join(out, "1.csv"))) == 2
    assert "generate_programs: configs=1 programs=1" in text


@pytest.mark.parametrize("mode", ["reference", "figstep"])
def test_baseline_cli_runs_qwen(tmp_path, mode, capsys, one_thread):
    """cli/baseline_tests.py --model qwen (Qwen/Qwen2-VL-2B-Instruct) on a fabricated tiny-qwen2vl
    checkpoint directory, on the CPU at its 128 new tokens: the text mode, and FigStep with its
    76² PNGs host-resized to the victim's 448² (eval_target_hw, the processor's in_hw: 1024 patches,
    256 image tokens a row); a row per question or image and one decode configuration."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt

    root = str(tmp_path / "ckpts")
    fabricate_ckpt.main(["tiny-qwen2vl", root, "--device", "cpu"])
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text("How?\nWhy?\n")
    ds = tmp_path / "datasets"
    d = ds / "FigStep" / "images" / "1_with_titles"
    d.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(smooth_image(76, 76, 50 + i)).save(d / f"{i}.png")
    out = baseline_tests.main(["--model", "qwen", "--mode", mode, "--sfb_path", str(sfb), "--dataset_root",
                               str(ds), "--tests_path", str(tmp_path / "tests"), "--categories", "1",
                               "--batch_size", "2", "--checkpoint_root", root, "--device", "cpu"])
    text = capsys.readouterr().out
    sub = {"reference": "reference", "figstep": "FigStep_baseline"}[mode]
    assert out == os.path.join(str(tmp_path / "tests"), sub, "qwen")
    assert os.listdir(out) == ["1.csv"] and len(read_column(os.path.join(out, "1.csv"))) == 2
    assert "generate_programs: configs=1 programs=1" in text
    assert "images at 448x448, 256 image tokens a row" in text  # 32×32 patches, merged 2×2


@pytest.mark.parametrize("mode", ["reference", "figstep"])
def test_baseline_cli_runs_phi35(tmp_path, mode, capsys, one_thread):
    """cli/baseline_tests.py --model phi35 (microsoft/Phi-3.5-vision-instruct) on a fabricated
    tiny-phi3v checkpoint directory, on the CPU at its 128 new tokens: the text mode, and FigStep
    with its 76² PNGs host-resized to the victim's 448² (planned to 672²: a 2×2 grid of 336²
    tiles, 199 image tokens a row with the tiny tower's 6×6 merged grid); a row per question or
    image and one decode configuration."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt

    root = str(tmp_path / "ckpts")
    fabricate_ckpt.main(["tiny-phi3v", root, "--device", "cpu"])
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text("How?\nWhy?\n")
    ds = tmp_path / "datasets"
    d = ds / "FigStep" / "images" / "1_with_titles"
    d.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(smooth_image(76, 76, 50 + i)).save(d / f"{i}.png")
    out = baseline_tests.main(["--model", "phi35", "--mode", mode, "--sfb_path", str(sfb), "--dataset_root",
                               str(ds), "--tests_path", str(tmp_path / "tests"), "--categories", "1",
                               "--batch_size", "2", "--checkpoint_root", root, "--device", "cpu"])
    text = capsys.readouterr().out
    sub = {"reference": "reference", "figstep": "FigStep_baseline"}[mode]
    assert out == os.path.join(str(tmp_path / "tests"), sub, "phi35")
    assert os.listdir(out) == ["1.csv"] and len(read_column(os.path.join(out, "1.csv"))) == 2
    assert "generate_programs: configs=1 programs=1" in text
    assert "images at 448x448, 199 image tokens a row" in text


@pytest.mark.parametrize("model", ["llama"])
def test_baseline_cli_refuses_other_families_before_any_file(tmp_path, model, capsys, one_thread):
    """The llama name (alpindale/Llama-3.2-11B-Vision-Instruct) resolves to the mllama family since
    it was ported: without a checkpoint directory it stops at "no local checkpoint" before any file
    is read (no dataset exists; a reversed category range raises first), and on a fabricated
    tiny-mllama directory the text mode runs on the CPU, a row per question, one <|image|> token a
    row."""
    from adversarialvlm_tpu_torch.cli import fabricate_ckpt
    from adversarialvlm_tpu_torch.cli.attack_model import victim_family

    missing = str(tmp_path / "missing")
    args = ["--model", model, "--mode", "figstep", "--dataset_root", missing, "--checkpoint_root", missing,
            "--tests_path", missing, "--device", "cpu"]
    assert victim_family(baseline_tests.MODELS[model]) == "mllama"
    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
        baseline_tests.main(args)
    with pytest.raises(ValueError, match="reversed"):
        baseline_tests.main(args + ["--categories", "3-1"])
    assert not os.path.exists(missing)
    assert baseline_tests.MODELS == {"llama": "alpindale/Llama-3.2-11B-Vision-Instruct",
                                     "qwen": "Qwen/Qwen2-VL-2B-Instruct",
                                     "phi35": "microsoft/Phi-3.5-vision-instruct",
                                     "llava": "llava-hf/llava-1.5-7b-hf"}
    root = str(tmp_path / "ckpts")
    fabricate_ckpt.main(["tiny-mllama", root, "--device", "cpu"])
    sfb = tmp_path / "sfb"
    sfb.mkdir()
    (sfb / "1.csv").write_text("How?\nWhy?\n")
    out = baseline_tests.main(["--model", model, "--mode", "reference", "--sfb_path", str(sfb), "--tests_path",
                               str(tmp_path / "tests"), "--categories", "1", "--batch_size", "2",
                               "--checkpoint_root", root, "--device", "cpu"])
    assert out == os.path.join(str(tmp_path / "tests"), "reference", model)
    assert os.listdir(out) == ["1.csv"] and len(read_column(os.path.join(out, "1.csv"))) == 2
    text = capsys.readouterr().out
    assert "generate_programs: configs=1 programs=1" in text and "1 image tokens a row" in text
