"""The port's OCR stack against the JAX package on the CPU: the
tokenizers, ``TrOCRTransform``, TrOCR (encoder, teacher-forced logits,
loss and gradients, the cached decode step, greedy and beam decoding,
the beam's order among tied candidates), the OCR task through the
Trainer's bf16 policy, the character error rate and ``valid``.

Micro size: TrOCR with a 40-token vocabulary, encoder 32 wide, 1 layer, 2
heads, decoder 32 wide, 2 layers, 2 heads, 32 px images in 8 px patches
(17 tokens), ``max_length`` 8, b2, as ``tests/test_ocr.py`` builds it.
Weights are the JAX model's, copied by the bridge.  Every JAX reference
is computed once, in a module fixture, on the JAX attention's default
einsum path.  Tolerances: f32 within 2e-4 of the largest magnitude
(logits, memory, gradients); the loss within 1e-5 relative; greedy and
beam tokens, the tokenizers and the uint8 resize exact; a float image's
resize within 1e-4 of its range of ``cv2.resize``; the Trainer's first
bf16 step's loss within 1e-4 relative (bf16 self-attention in the
decoder's first layer, rounded in another order: 1.7e-5 measured).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tests.test_torch_cls_classic import zero_init  # noqa: F401
from tests.test_torch_seg_zoo import _close, _flat
from tests.test_torch_trainer import _jax_steps, _port_steps
from tlxcv_tpu.config import create_model as jax_create_model
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.ocr import transform as JX
from tlxcv_tpu.models.ocr.trocr import TrOCR as JTrOCR
from tlxcv_tpu.tasks import OpticalCharacterRecognition as JOCR
from tlxcv_tpu.tasks import ocr as JO
from tlxcv_tpu.train import Trainer as JTrainer
from tlxcv_tpu.train import optimizers as JOpt
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.ocr import transform as TX
from tlxcv_tpu_torch.models.ocr.trocr import TrOCR, _top_k
from tlxcv_tpu_torch.tasks import OpticalCharacterRecognition
from tlxcv_tpu_torch.tasks import ocr as TO
from tlxcv_tpu_torch.train import Trainer
from tlxcv_tpu_torch.train import optimizers as TOpt
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

MICRO = dict(vocab_size=40, encoder_dim=32, encoder_depth=1, encoder_heads=2,
             decoder_dim=32, decoder_depth=2, decoder_heads=2, img_size=32,
             patch_size=8, max_length=8)


def _port(jm, **kw):
    tm = TrOCR(**{**MICRO, **kw}, device="cpu")
    load_jax_params(tm, _flat(jm))
    return tm.eval()


def _labels(rng, b=2, n=8):
    """Label ids with an EOS and PAD tail on the second row."""
    y = rng.integers(3, 40, size=(b, n)).astype(np.int32)
    y[1, 5], y[1, 6:] = 2, 1
    return y


@pytest.fixture(scope="module")
def trocr():
    """The micro TrOCR, its port, and the JAX references on one batch:
    memory, teacher-forced logits, loss and gradients, greedy and 3-beam
    tokens."""
    rng = np.random.default_rng(21)
    jm = JTrOCR(**MICRO)
    tm = _port(jm)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = _labels(rng)
    params, state = split(jm)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    bos = jnp.full((2, 1), jm.bos_token_id, jnp.int32)
    inputs = jnp.concatenate([bos, yj[:, :-1]], 1)
    loss_fn = pure(jm, lambda m, v, t: m.loss_fn(v, t))
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(p, state, xj, yj)[0])(params)
    ref = {
        "memory": pure(jm, lambda m, v: m.encode(v))(params, state, xj)[0],
        "logits": jax.jit(lambda p, s: pure(jm)(p, s, xj, inputs)[0])(
            params, state),
        "loss": float(loss), "grads": grads,
        "greedy": jax.jit(lambda p, s: pure(
            jm, lambda m, v: m.generate(v))(p, s, xj)[0])(params, state),
        "beam": jax.jit(lambda p, s: pure(
            jm, lambda m, v: m.generate_beam(v, num_beams=3))(p, s, xj)[0])(
            params, state),
    }
    return jm, tm, x, y, {k: (v if k == "grads" else np.asarray(v))
                          for k, v in ref.items()}


def test_encoder_and_teacher_forced_logits_match_jax(trocr):
    jm, tm, x, y, ref = trocr
    xt = torch.from_numpy(x)
    inputs = torch.cat([torch.zeros(2, 1, dtype=torch.long),
                        torch.from_numpy(y[:, :-1]).long()], 1)
    with torch.no_grad():
        memory = tm.encode(xt)
        _close(memory, ref["memory"])
        logits = tm(xt, inputs)
    assert logits.shape == (2, 8, 40)
    _close(logits, ref["logits"])


def test_loss_and_gradients_match_jax(trocr):
    jm, tm, x, y, ref = trocr
    tm.zero_grad()
    loss = tm.loss_fn(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    grads = {k.replace("/", "."): np.asarray(g)
             for k, g in ref["grads"].items()}
    largest = max(np.abs(g).max() for g in grads.values())
    for key, want in grads.items():
        p = tm.get_parameter(key)
        want = _to_port_layout(*_owner(tm, key), want)
        if key.endswith(".k.bias"):
            # zero by the softmax's shift invariance: rounding noise on
            # both sides, held against the largest gradient instead
            assert np.abs(p.grad.numpy()).max() <= 1e-6 * largest, key
            continue
        _close(p.grad, want)
    assert tm.decoder.embed_tokens.weight.grad.abs().sum() > 0


def test_decode_step_matches_the_full_decoder(trocr):
    """The cached step at every position on the teacher-forced inputs
    gives the full decoder's logits at that position (and JAX's)."""
    jm, tm, x, y, ref = trocr
    inputs = torch.cat([torch.zeros(2, 1, dtype=torch.long),
                        torch.from_numpy(y[:, :-1]).long()], 1)
    with torch.no_grad():
        memory = tm.encode(torch.from_numpy(x))
        full = tm.decoder(inputs, memory)
        cache = tm.decoder.init_cache(2, tm.max_length)
        kvs = tm.decoder.memory_kv(memory)
        for pos in range(tm.max_length):
            step, cache = tm.decoder.decode_step(inputs[:, pos], pos, memory,
                                                 cache, kvs)
            _close(step, full[:, pos])
            _close(step, ref["logits"][:, pos])


def test_greedy_and_beam_tokens_are_the_references(trocr):
    jm, tm, x, y, ref = trocr
    xt = torch.from_numpy(x)
    greedy = tm.generate(xt)
    assert greedy.dtype == torch.int32 and greedy.shape == (2, 8)
    np.testing.assert_array_equal(greedy.numpy(), ref["greedy"])
    np.testing.assert_array_equal(tm.generate_beam(xt, num_beams=3).numpy(),
                                  ref["beam"])
    with torch.no_grad():
        np.testing.assert_array_equal(tm(xt).numpy(), ref["greedy"])


@pytest.mark.parametrize("shape,k", [((3, 12), 4), ((2, 40), 3)])
def test_top_k_breaks_ties_as_jax(rng, shape, k):
    """Rows of few distinct values: ``_top_k`` picks tied values in index
    order, as ``jax.lax.top_k`` does."""
    x = rng.integers(0, 3, size=shape).astype(np.float32)
    values, index = _top_k(torch.from_numpy(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(index.numpy(), np.asarray(want_i))


def test_beam_order_among_tied_candidates_is_the_references(rng):
    """A zero output projection makes every token equally likely: every
    candidate of every step ties, and the beams are decided by the order
    of the ties alone."""
    jm = JTrOCR(**{**MICRO, "max_length": 4})
    jm.decoder.output_projection.weight.value = jnp.zeros((32, 40))
    tm = _port(jm, max_length=4)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = pure(jm, lambda m, v: m.generate_beam(v, num_beams=4))(
        *split(jm), jnp.asarray(x))[0]
    got = tm.generate_beam(torch.from_numpy(x), num_beams=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ocr_task_train_mode_hands_the_images_on(trocr):
    jm, tm, x, y, ref = trocr
    task = OpticalCharacterRecognition(tm)
    xt = torch.from_numpy(x)
    task.train()
    assert task(xt) is xt
    task.eval()
    np.testing.assert_array_equal(task(xt).numpy(), ref["greedy"])
    np.testing.assert_array_equal(task.predict(xt).numpy(), ref["greedy"])
    np.testing.assert_allclose(
        task.loss_fn(xt, torch.from_numpy(y)).item(), ref["loss"], rtol=1e-5)


def test_trainer_bf16_step_matches_jax(rng):
    """One AdamW step of the OCR task through both Trainers in bf16 over
    f32 masters: the output handed to ``loss_fn`` is the images, cast to
    bf16 and back to f32, so the encoder runs in f32 on bf16-rounded
    weights, and the decoder in mixed precision, as in the reference."""
    jm = JTrOCR(**MICRO)
    tm = _port(jm)
    jt, tt = JOCR(jm), OpticalCharacterRecognition(tm)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = _labels(rng)
    jtr = JTrainer(jt, loss_fn=lambda o, t: jm.loss_fn(o, t),
                   optimizer=JOpt.AdamW(5e-5), compute_dtype=jnp.bfloat16)
    ttr = Trainer(tt, loss_fn=lambda o, t: tm.loss_fn(o, t),
                  optimizer=TOpt.AdamW(5e-5), compute_dtype=torch.bfloat16,
                  device="cpu")
    _, _, _, (jloss,) = _jax_steps(jtr, [(x, y)])
    (tloss,) = _port_steps(ttr, [(x, y)])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_char_tokenizer_matches_jax():
    tok, ref = TX.CharTokenizer(), JX.CharTokenizer()
    for text in ("hello42", "Mixed CASE 09!", ""):
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))
    assert tok.decode([0, 1, 2, 5, 39, 40]) == ref.decode([0, 1, 2, 5, 39,
                                                           40])
    assert tok.vocab_size == ref.vocab_size == 39


_MERGES = ["h e", "l l", "he ll", "hell o", "Ġ w", "o r", "Ġw or", "l d",
           "Ġwor ld", "1 2", "12 3", "Ġ t", "Ġt h", "e Ġ", "' s", "i t"]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """A byte-level vocabulary (the 256 byte symbols, the specials and the
    merged symbols) and its merges, written by hand."""
    d = tmp_path_factory.mktemp("bpe")
    symbols = ["<s>", "<pad>", "</s>", "<unk>"] + list(
        TX.bytes_to_unicode().values()) + ["".join(m.split())
                                           for m in _MERGES]
    vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(_MERGES)
                                  + "\n", encoding="utf-8")
    return str(d / "vocab.json"), str(d / "merges.txt")


BPE_CASES = ["hello world", "hello  world 123", "the world's it",
             "I'll don't it's", "  two  spaces\n", "naïve café ☕", "x"]


def test_bpe_tokenizer_matches_jax(bpe_files):
    tok, ref = TX.BPETokenizer(*bpe_files), JX.BPETokenizer(*bpe_files)
    assert (tok.bos_token_id, tok.pad_token_id, tok.eos_token_id) == (0, 1,
                                                                      2)
    for text in BPE_CASES:
        ids = tok.encode(text)
        assert ids == ref.encode(text), text
        assert tok.decode(ids) == ref.decode(ids) == text
    assert tok.encode("hello") == [tok.encoder["hello"]]


def test_bpe_tokenizer_matches_gpt2_tokenizer(bpe_files):
    transformers = pytest.importorskip("transformers")
    ref = transformers.GPT2Tokenizer(*bpe_files)
    tok = TX.BPETokenizer(*bpe_files)
    for text in BPE_CASES:
        assert tok.encode(text) == ref.encode(text), text


@pytest.mark.parametrize("hw,channels", [((32, 100), 3), ((31, 129), 3),
                                         ((400, 500), 3), ((20, 30), None),
                                         ((45, 60), 1)])
def test_trocr_transform_matches_jax(rng, bpe_files, hw, channels):
    """uint8 images (what PIL hands Synth90k) bitwise through OpenCV's
    fixed-point route, float images within 1e-4 of their range; the text
    ids exactly."""
    pytest.importorskip("cv2")
    shape = hw if channels is None else (*hw, channels)
    tok, ref = TX.BPETokenizer(*bpe_files), JX.BPETokenizer(*bpe_files)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    got, ids = TX.TrOCRTransform(tok, size=(64, 48), max_length=6)(
        img, "hello world 123")
    want, want_ids = JX.TrOCRTransform(ref, size=(64, 48), max_length=6)(
        img, "hello world 123")
    assert got.shape == (64, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ids, want_ids)
    f = img.astype(np.float32)
    np.testing.assert_allclose(
        TX.TrOCRTransform(tok, size=(384, 384))(f),
        JX.TrOCRTransform(ref, size=(384, 384))(f), rtol=0,
        atol=1e-4 * 2)


def test_resize_linear_is_cv2_on_random_uint8_sizes(rng):
    cv2 = pytest.importorskip("cv2")
    for _ in range(40):
        h, w = rng.integers(1, 90, size=2)
        oh, ow = rng.integers(1, 200, size=2)
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(TX.resize_linear(img, (oh, ow)),
                                      cv2.resize(img, (int(ow), int(oh))))


def test_cer_and_edit_distance_match_jax():
    for a, b in (("kitten", "sitting"), ("", "abc"), ("abc", ""),
                 ("flaw", "lawn"), ("same", "same")):
        assert TO.edit_distance(a, b) == JO.edit_distance(a, b)
    preds, refs = ["abd", "hello", ""], ["abc", "help", "xy"]
    assert TO.character_error_rate(preds, refs) == \
        JO.character_error_rate(preds, refs)
    assert TO.character_error_rate(["abd"], ["abc"]) == pytest.approx(1 / 3)


def test_valid_matches_jax(trocr):
    """Greedy CER over a two-batch dataset, the port's task against the
    reference's ``valid`` on its jitted greedy decode."""
    jm, tm, x, y, ref = trocr
    tok = TX.CharTokenizer("abcdefghijklmnopqrstuvwxyz0123456789")
    data = [(x, y), (x[::-1].copy(), y[::-1].copy())]
    gen = jax.jit(lambda p, s, v: pure(jm, lambda m, a: m.generate(a))(
        p, s, v)[0])

    class JaxGreedy:
        @staticmethod
        def predict(images):
            return gen(*split(jm), jnp.asarray(images))

    task = OpticalCharacterRecognition(tm).eval()
    got = TO.valid(task, [(torch.from_numpy(a), b) for a, b in data], tok)
    assert got == JO.valid(JaxGreedy, data, tok) > 0


def test_trocr_registry_builds(zero_init):
    """``create_model("trocr")`` under the JAX name with the JAX model's
    parameter count (vocabulary 64,044, the demo's encoder and decoder)."""
    model = create_model("trocr", device="cpu")
    count = sum(a.size for a in _flat(jax_create_model("trocr")).values())
    assert sum(p.numel() for p in model.state_dict().values()) == count
    assert model.decoder.output_projection.weight.shape == (64044, 256)
