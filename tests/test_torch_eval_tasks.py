"""The eval tasks zeroshot, mcqa, videoqa, mcq_benchmark and grounding in the
PyTorch port vs the JAX package, on the CPU.

The scorers, drivers and demo helpers run on the JAX tests' data
(tests/test_chat_demo.py, tests/test_mllm_benchmark.py, tests/test_data.py)
beside their JAX functions and must give the same results. The port's eval
CLI runs zeroshot and mcqa on the tiny configs beside the JAX CLI, in one
process (configs/eval_zeroshot_tiny.py tokenizes with Python's `hash`), on
the JAX CLI's own init weights through `params_from_jax`: the same printed
metrics, and the text / video / choice features within 1e-5. The three
generation tasks run through the port's CLI on configs/torch's tiny
configs and give the JAX functions' numbers on the same data.
"""

import contextlib
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import internvideo_tpu_torch.models.videoclip as tvc
from internvideo_tpu.cli import eval as jcli
from internvideo_tpu.data import transforms as jtr
from internvideo_tpu.eval import demo as jdemo
from internvideo_tpu.eval import grounding as jgr
from internvideo_tpu.eval import mcqa as jmcqa
from internvideo_tpu.eval import mllm_benchmark as jmb
from internvideo_tpu.eval import videoqa as jqa
from internvideo_tpu.eval import zeroshot as jzs
from internvideo_tpu_torch.cli import eval as cli
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.data import transforms as ttr
from internvideo_tpu_torch.eval import demo as tdemo
from internvideo_tpu_torch.eval import grounding as tgr
from internvideo_tpu_torch.eval import mcqa as tmcqa
from internvideo_tpu_torch.eval import mllm_benchmark as tmb
from internvideo_tpu_torch.eval import videoqa as tqa
from internvideo_tpu_torch.eval import zeroshot as tzs
from internvideo_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --- videoqa scorers (tests/test_chat_demo.py:105-138) ----------------------------

QA_CASES = [("The Cat!", ["the cat"]), ("i think it is a red car.", ["red car"]),
            ("blue", ["red"]), ("An apple, a day", ["apple day"]), ("", ["x"])]


@pytest.mark.parametrize("pred,golds", QA_CASES)
def test_videoqa_matchers_match_jax(pred, golds):
    assert tqa.normalize_answer(pred) == jqa.normalize_answer(pred)
    assert tqa.exact_match(pred, golds) == jqa.exact_match(pred, golds)
    assert tqa.substring_match(pred, golds) == jqa.substring_match(pred, golds)


@pytest.mark.parametrize("text", ["The answer is (B).", "C", "no option here", "d) maybe", ""])
def test_mcq_option_matches_jax(text):
    assert tqa.mcq_option(text) == jqa.mcq_option(text)


@pytest.mark.parametrize("matcher", ["substring", "exact", "mcq"])
def test_evaluate_videoqa_matches_jax(matcher):
    data = [{"answers": [["red car"], ["dog"]], "option": ["a", "b"]},
            {"answers": [["the cat"], ["blue"]], "option": ["c", "d"]}]
    answers = iter([["a red car driving", "a cat"], ["The cat", "the answer is B"]] * 2)
    gen = lambda batch: next(answers)  # noqa: E731
    assert tqa.evaluate_videoqa(gen, data, matcher=matcher) == jqa.evaluate_videoqa(
        gen, data, matcher=matcher)


# --- MCQ benchmark and grounding (tests/test_mllm_benchmark.py) ---------------------


def _mcq_items():
    rng = np.random.default_rng(0)
    return [{"question": f"q{i}", "options": [f"{letter}. opt" for letter in "ABCD"],
             "answer": "ABCD"[int(rng.integers(0, 4))],
             "category": "short" if i % 2 == 0 else "long", "video": f"v{i}.mp4"}
            for i in range(12)]


@pytest.mark.parametrize("text", ["B", "b. because ...", "The answer is C", "answer: d", "",
                                  "The man runs", "(A) and B"])
def test_parse_option_letter_matches_jax(text):
    assert tmb.parse_option_letter(text) == jmb.parse_option_letter(text)


def test_mcq_prompts_and_items_match_jax(tmp_path):
    for args in ((("What happens?", ["A. runs", "B. sits"])),
                 (("Q?", ["A. x"], "hello world"))):
        assert tmb.build_mcq_prompt(*args) == jmb.build_mcq_prompt(*args)
    items = _mcq_items()
    path = tmp_path / "bench.jsonl"
    path.write_text("".join(json.dumps(it) + "\n" for it in items))
    assert tmb.load_benchmark_items(str(path)) == jmb.load_benchmark_items(str(path)) == items


@pytest.mark.parametrize("shard_hosts", [False, True])
def test_run_mcq_benchmark_matches_jax(tmp_path, shard_hosts):
    items = _mcq_items()

    def gen(prompt, video):
        i = int(video[1:-4])
        return f"The answer is {items[i]['answer']}" if i % 2 == 0 else "Z unknowable"

    outs = {}
    for tag, mod in (("jax", jmb), ("port", tmb)):
        outs[tag] = mod.run_mcq_benchmark(items, gen, shard_hosts=shard_hosts,
                                          predictions_path=str(tmp_path / f"{tag}.jsonl"))
    assert outs["port"] == outs["jax"] and outs["port"]["n"] == 12
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()


def test_sharding_across_processes_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tmb, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        tmb.run_mcq_benchmark(_mcq_items(), lambda p, v: "A", shard_hosts=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        tgr.run_grounding_eval([{"video": "a", "query": "x", "span": (0, 1)}],
                               lambda p, v: "0 1", results_path=str(tmp_path / "r.jsonl"))


@pytest.mark.parametrize("text", ["from 3.5 to 10 seconds", "no numbers here", "7", "1 2 3"])
def test_parse_time_span_matches_jax(text):
    assert tgr.parse_time_span(text) == jgr.parse_time_span(text)


@pytest.mark.parametrize("pred,gt", [((0, 10), (0, 10)), ((0, 5), (5, 10)), ((0, 6), (4, 10)),
                                     ((None, None), (0, 10)), ((10, 0), (0, 10)),
                                     ((3, 3), (3, 3))])
def test_span_iou_matches_jax(pred, gt):
    assert tgr.span_iou(pred, gt) == jgr.span_iou(pred, gt)


def test_run_grounding_eval_matches_jax(tmp_path):
    queries = [{"video": "a.mp4", "query": "x", "span": (2.0, 8.0)},
               {"video": "b.mp4", "query": "y", "span": (0.0, 4.0), "category": "s"},
               {"video": "c.mp4", "query": "z", "span": (5.0, 9.0), "category": "s"}]
    answers = {"a.mp4": "2.0 to 8.0", "b.mp4": "0 4.4", "c.mp4": "maybe never"}
    gen = lambda prompt, video: answers[video]  # noqa: E731
    outs = {tag: mod.run_grounding_eval(queries, gen, results_path=str(tmp_path / f"{tag}.jsonl"))
            for tag, mod in (("jax", jgr), ("port", tgr))}
    assert outs["port"] == outs["jax"] and outs["port"]["n"] == 3
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    assert tgr.grounding_metrics([0.1, 0.5, 0.9]) == jgr.grounding_metrics([0.1, 0.5, 0.9])


# --- zero-shot and MC-QA scoring --------------------------------------------------


def test_zero_shot_classifier_and_eval_match_jax():
    rng = np.random.default_rng(3)
    table = {}

    def encode_texts(texts):
        return np.stack([table.setdefault(t, rng.standard_normal(8).astype(np.float32))
                         for t in texts])

    names = ["running", "swimming", "cooking", "juggling", "reading", "eating"]
    want = jzs.build_zero_shot_classifier(encode_texts, names)
    got = tzs.build_zero_shot_classifier(lambda t: torch.from_numpy(encode_texts(t)), names)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    proj = rng.standard_normal((3, 8)).astype(np.float32)
    batches = [{"video": np.arange(5) % 3, "label": np.array([0, 1, 2, 5, 4])},
               {"video": np.arange(2), "label": np.array([0, 3])}]  # a ragged tail
    enc = lambda idx: proj[np.asarray(idx)]  # noqa: E731
    assert tzs.zero_shot_eval(lambda v: torch.from_numpy(enc(v)), got, batches) == \
        jzs.zero_shot_eval(enc, want, batches)


def test_mcqa_accuracy_and_map_match_jax():
    rng = np.random.default_rng(4)
    data = [{"video": rng.standard_normal((3, 8)).astype(np.float32),
             "choice_ids": rng.integers(0, 50, (3, 4, 5)),
             "answer": rng.integers(0, 4, 3)} for _ in range(3)]
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    enc_v = lambda v: v  # noqa: E731
    enc_c = lambda ids: emb[ids].mean(1)  # noqa: E731
    rerank = lambda v, ids: 0.1 * ids.sum(-1).astype(np.float32)  # noqa: E731
    for kw in ({}, {"rerank": rerank}):
        t_kw = {k: (lambda v, ids, f=f: torch.from_numpy(f(v, ids))) for k, f in kw.items()}
        got = tmcqa.mcqa_accuracy(lambda v: torch.from_numpy(enc_v(v)),
                                  lambda i: torch.from_numpy(enc_c(i)), data, **t_kw)
        assert got == jmcqa.mcqa_accuracy(enc_v, enc_c, data, **kw)
    scores, answers = rng.standard_normal((9, 4)), rng.integers(0, 3, 9)
    assert tmcqa.multiple_choice_map(scores, answers) == jmcqa.multiple_choice_map(scores,
                                                                                   answers)


# --- demo helpers and transforms (tests/test_chat_demo.py:62-86, test_data.py:58-77) ---


def test_retrieve_text_and_preprocess_clip_match_jax():
    frames = (np.random.default_rng(5).random((4, 40, 52, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tdemo.preprocess_clip(frames, 28),
                                  jdemo.preprocess_clip(frames, 28))
    emb = {"a": [1, 0], "b": [0.9, 0.1], "c": [0, 1]}
    kw = dict(tokenize=lambda ts: ts, topk=2, img_size=28)
    top, probs = tdemo.retrieve_text(
        frames, ["a", "b", "c"], encode_video=lambda clip: torch.tensor([[1.0, 0.0]]),
        encode_text=lambda ts: torch.tensor([emb[t] for t in ts]), **kw)
    jtop, jprobs = jdemo.retrieve_text(
        frames, ["a", "b", "c"], encode_video=lambda clip: np.array([[1.0, 0.0]], np.float32),
        encode_text=lambda ts: np.array([emb[t] for t in ts], np.float32), **kw)
    assert top == jtop == ["a", "b"]
    np.testing.assert_allclose(probs, jprobs, rtol=1e-6)


TRANSFORM_CASES = {
    "resize_short_side": lambda m, clip, rng: m.resize_short_side(clip, 32),
    "resize": lambda m, clip, rng: m.resize(clip, (20, 36)),
    "center_crop": lambda m, clip, rng: m.center_crop(m.resize_short_side(clip, 32), 32),
    "random_crop": lambda m, clip, rng: m.random_crop(clip, 24, rng),
    "random_resized_crop": lambda m, clip, rng: m.random_resized_crop(clip, 24, rng),
    "horizontal_flip": lambda m, clip, rng: m.horizontal_flip(clip, rng, p=1.0),
    "multi_scale_crop": lambda m, clip, rng: m.multi_scale_crop(clip, 24, rng),
    "normalize": lambda m, clip, rng: m.normalize(clip),
    "rand_augment": lambda m, clip, rng: m.rand_augment(clip, rng, num_ops=2, magnitude=9),
    "random_erasing": lambda m, clip, rng: m.random_erasing(clip, rng, p=1.0),
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transforms_match_jax(name):
    clip = (np.random.default_rng(6).random((4, 64, 48, 3)) * 255).astype(np.uint8)
    got = TRANSFORM_CASES[name](ttr, clip, np.random.default_rng(3))
    want = TRANSFORM_CASES[name](jtr, clip, np.random.default_rng(3))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- the CLIs ---------------------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _record_features(monkeypatch, mod, fn_name, fn_args, store):
    """Wrap `mod.fn_name` so that the encoder callables among its arguments
    (`fn_args`: their positions) record their outputs in `store`."""
    orig = getattr(mod, fn_name)

    def wrapped(*args, **kw):
        args = list(args)
        for i in fn_args:
            enc = args[i]

            def recording(x, enc=enc, i=i):
                out = enc(x)
                store.setdefault(i, []).append(_np(out))
                return out

            args[i] = recording
        if fn_name == "zero_shot_eval":
            store["classifier"] = [np.asarray(args[1])]
        return orig(*args, **kw)

    monkeypatch.setattr(mod, fn_name, wrapped)


@pytest.mark.parametrize("task", ["zeroshot", "mcqa"])
def test_cli_matches_jax_cli(monkeypatch, task):
    fn_name, fn_args, mods = {
        "zeroshot": ("zero_shot_eval", (0,), (jzs, tzs)),
        "mcqa": ("mcqa_accuracy", (0, 1), (jmcqa, tmcqa))}[task]
    captured, feats = {}, {"jax": {}, "port": {}}
    load_params = jcli._load_params

    def capture(model, init_params, checkpoint, convert):
        captured["params"] = jax.tree.map(np.asarray, jax.device_get(unbox(init_params)))
        return load_params(model, init_params, checkpoint, convert)

    monkeypatch.setattr(jcli, "_load_params", capture)
    _record_features(monkeypatch, mods[0], fn_name, fn_args, feats["jax"])
    want = _run(jcli.main, ["--config", str(ROOT / f"configs/eval_{task}_tiny.py")])

    def videoclip(run, device):
        model = tvc.VideoCLIP(run.model, device=device, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(params_from_jax(captured["params"], run.model), strict=True)
        return model.eval()

    monkeypatch.setattr(cli, "_videoclip", videoclip)
    _record_features(monkeypatch, mods[1], fn_name, fn_args, feats["port"])
    got = _run(cli.main, ["--config", str(ROOT / f"configs/torch/eval_{task}_tiny.py"),
                          "--device", "cpu"])
    assert got == want
    assert got["num" if task == "mcqa" else "n"] == 6
    assert feats["port"].keys() == feats["jax"].keys() and feats["port"]
    for key, outs in feats["jax"].items():
        assert len(feats["port"][key]) == len(outs)
        for a, b in zip(feats["port"][key], outs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("task", ["videoqa", "mcq_benchmark", "grounding"])
def test_cli_generation_tasks_give_jax_numbers(task):
    name = {"videoqa": "chat_videoqa_tiny", "mcq_benchmark": "eval_mcq_benchmark_tiny",
            "grounding": "eval_grounding_tiny"}[task]
    path = str(ROOT / f"configs/torch/{name}.py")
    got = _run(cli.main, ["--config", path, "--device", "cpu"])
    run = load_config(path)
    if task == "videoqa":
        gen, data = run.data(model=run.model, device=torch.device("cpu"))
        want = jqa.evaluate_videoqa(gen, data, **run.options)
    elif task == "mcq_benchmark":
        want = jmb.run_mcq_benchmark(*run.data(), **run.options)
    else:
        want = jgr.run_grounding_eval(*run.data(), **run.options)
    want = {"task": task, **{k: (round(float(v), 4) if hasattr(v, "__float__") else v)
                             for k, v in want.items()}}
    assert got == want


def test_zeroshot_1b_config_tokenizes_within_bert_vocab():
    run = load_config(str(ROOT / "configs/torch/eval_zeroshot_stage2_1b.py"))
    names, tokenize, _ = run.data()
    t = tokenize([f"A video of {n}." for n in names])
    assert t["input_ids"].shape == (len(names), 16)
    assert (t["input_ids"][:, 0] == 101).all() and t["input_ids"].max() < run.model.text.vocab_size
    assert ((t["input_ids"] > 0) == (t["attention_mask"] > 0)).all()
