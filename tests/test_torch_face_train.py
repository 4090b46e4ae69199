"""The face models trained through the port's Trainer, one SGD step
against the JAX Trainer's on the CPU: RetinaFace-R50 on ``Encoder``
targets with ``multi_box_loss`` (its FPN merges are the upsample-add
Function, whose backward is the transposed resize), and ArcFace on a
ResNet-18 with its margin head at a margin-warm-up value.

Micro size: RetinaFace at full width on 64 px frames, b2, faces drawn
from a numpy seed; ArcFace on ResNet-18 at 64 px with a 32-wide
embedding and 10 classes, b4, dropout off on both sides.  Weights are the
JAX model's, copied by the bridge, every BatchNorm's statistics and
affine drawn first; RetinaFace's class and box convs drawn as in
``tests/test_torch_face.py``.  Both sides in f32 with oneDNN off.
Tolerances: the loss within 1e-4 relative (1.0e-5 measured on
RetinaFace's 215); each BatchNorm statistic within 2e-4 of its largest
magnitude (``tests/test_parity_resnet.py:91``'s f32 bound).  Each
parameter's change (-lr g) is held by its cosine with the JAX change,
at least ``MIN_COSINE``: train-mode BatchNorm over two (RetinaFace) and
four (ArcFace) images puts pre-activations within rounding of a ReLU's
kink in both packages, and a kink that flips moves a few elements of a
gradient by up to 14% of its largest (0.03% of layer4's elements in one
ArcFace run, at 4 threads and not at 2), while a missing or wrong
gradient path turns the whole direction.  A parameter the JAX step
leaves unchanged (RetinaFace's level-2 SSH at 64 px: its priors get no
positive and no mined negative) must stay unchanged; ArcFace's ``bn``
and ``dense`` biases, whose gradient is zero (``bn2`` takes out any
shift), must move by less than 1e-6 of the largest change.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tests.test_torch_face import _faces
from tests.test_torch_seg_zoo import _close, _flat, _no_dropout, _random_bn
from tests.test_torch_trainer import (_in_port_layout, _jax_steps,
                                      _port_steps)
from tlxcv_tpu.models.classification import resnet18 as jax_resnet18
from tlxcv_tpu.models.face_recognition import ArcFace as JArcFace
from tlxcv_tpu.models.face_recognition import RetinaFace as JRetinaFace
from tlxcv_tpu.tasks import face_recognition as JT
from tlxcv_tpu.train import Trainer as JTrainer
from tlxcv_tpu.train import optimizers as JO
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.models.face_recognition import ArcFace, RetinaFace
from tlxcv_tpu_torch.models.face_recognition.arcface import _unit_rows
from tlxcv_tpu_torch.train import Trainer
from tlxcv_tpu_torch.train import optimizers as TO
from tlxcv_tpu_torch.utils import load_jax_params

MIN_COSINE = 0.999  # 0.99968 the least measured (RetinaFace, fpn)


def _retinaface(rng, side=64):
    jm = JRetinaFace(input_size=side)
    _random_bn(jm, rng)
    for heads, std in ((jm.classheads, 0.05), (jm.bboxheads, 0.002)):
        for head in heads:
            head.conv.weight.value = jnp.asarray(
                rng.normal(scale=std, size=head.conv.weight.value.shape),
                jnp.float32)
    tm = RetinaFace(input_size=side, device="cpu")
    load_jax_params(tm, _flat(jm))
    priors = JT.prior_box((side, side))
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    y = np.stack([JT.Encoder(priors)(_faces(rng, n)) for n in (2, 3)])
    return jm, tm, jm.loss_fn, tm.loss_fn, (x, y.astype(np.float32))


def _arcface(rng, margin=0.2, batch=4):
    jm = JArcFace(input_size=64, embed_size=32, num_classes=10,
                  backbone=jax_resnet18(num_classes=0, with_pool=False))
    _random_bn(jm, rng)
    tm = ArcFace(input_size=64, embed_size=32, num_classes=10,
                 backbone=resnet18(num_classes=0, with_pool=False,
                                   device="cpu"), device="cpu")
    load_jax_params(tm, _flat(jm))
    _no_dropout(jm, tm)
    x = rng.normal(size=(batch, 64, 64, 3)).astype(np.float32)
    y = (np.arange(batch) * 7 % 10).astype(np.int32)
    # the margin a warm-up schedule hands the loss at this step
    return (jm, tm,
            lambda e, t: jm.loss_fn(e, t, margin=jnp.float32(margin)),
            lambda e, t: tm.loss_fn(e, t.long(), margin=margin), (x, y))


@pytest.mark.parametrize("kind", ["retinaface", "arcface"])
def test_one_sgd_step_matches_jax(kind):
    lr = 0.01
    rng = np.random.default_rng(41)
    jm, tm, jloss_fn, tloss_fn, batch = (_retinaface if kind == "retinaface"
                                         else _arcface)(rng)
    jtr = JTrainer(jm, loss_fn=jloss_fn, optimizer=JO.SGD(lr))
    ttr = Trainer(tm, loss_fn=tloss_fn, optimizer=TO.SGD(lr), device="cpu")
    p0 = _in_port_layout(tm, jtr.params)
    p1, s1, _, (jloss,) = _jax_steps(jtr, [batch])
    (tloss,) = _port_steps(ttr, [batch])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    want = _in_port_layout(tm, p1)
    largest = max(np.abs(want[k] - p0[k]).max() for k in want)
    moved = 0
    for k, p in ttr.params.items():
        d_want = (want[k] - p0[k]).ravel().astype(np.float64)
        d_got = (p.detach().numpy() - p0[k]).ravel().astype(np.float64)
        if not d_want.any():
            assert not d_got.any(), k
        elif np.abs(d_want).max() < 1e-6 * largest:
            assert np.abs(d_got).max() < 1e-6 * largest, k
        else:
            moved += 1
            cos = d_want @ d_got / (np.linalg.norm(d_want)
                                    * np.linalg.norm(d_got))
            assert cos >= MIN_COSINE, (k, cos)
    assert moved >= 0.6 * len(ttr.params)
    for k, b in tm.named_buffers():
        _close(b, s1[k.replace(".", "/")])


def test_arcface_head_under_the_bf16_policy_matches_jax():
    """Under the Trainer's bf16 policy the loss takes f32 embeddings and the
    head's bf16 weight: the product runs in the promoted f32, as the
    reference's ``e @ w`` (the port raised there before).

    The head alone, tightly: its weight's columns normalised in bf16 within
    2^-6 of JAX's, relative (the norm and the quotient each round to bf16,
    at most 2^-7 apiece; 1.1e-2 measured), and its cosine logits (margin
    0) against JAX's ``e @ w`` on the port's own normalised bf16 weight,
    within 1e-5 of their largest magnitude, which f32 rounding sets (1.3e-7
    measured; a product in bf16 is 2.3e-3 off).  Then one step's loss
    against the JAX Trainer's in bf16, only within the JAX model's own
    bf16 distance from its f32 loss: this part shows that the step runs
    and stays finite (the bf16 backbone rounds in another order on each
    side; 0.02-2.1% apart against 4-69% own distance, measured over three
    seeds)."""
    rng = np.random.default_rng(43)
    jm, tm, _, _, _ = _arcface(rng)
    head = tm.head.to(torch.bfloat16)
    w = head.weight.detach()
    e = rng.normal(size=(4, w.shape[0])).astype(np.float32)
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    want_w = jw / (jnp.linalg.norm(jw, axis=0, keepdims=True) + 1e-9)
    got_w = _unit_rows(w, 0)
    assert got_w.dtype == torch.bfloat16
    want_w = np.asarray(want_w.astype(jnp.float32))
    assert (np.abs(got_w.float().numpy() - want_w)
            <= 2 ** -6 * np.abs(want_w)).all()
    logits = head(torch.from_numpy(e), torch.arange(4), margin=0.0)
    assert logits.dtype == torch.float32
    je = jnp.asarray(e)
    je = je / (jnp.linalg.norm(je, axis=1, keepdims=True) + 1e-9)
    cos = np.asarray(je @ jnp.asarray(got_w.float().numpy(), jnp.bfloat16))
    assert cos.dtype == np.float32
    _close(logits.detach() / head.logist_scale, cos, 1e-5)

    losses = {}
    for dtype in ("float32", "bfloat16"):
        rng = np.random.default_rng(43)
        jm, tm, jloss_fn, tloss_fn, batch = _arcface(rng)
        jtr = JTrainer(jm, loss_fn=jloss_fn, optimizer=JO.SGD(0.01),
                       compute_dtype=getattr(jnp, dtype))
        _, _, _, (losses["jax", dtype],) = _jax_steps(jtr, [batch])
    ttr = Trainer(tm, loss_fn=tloss_fn, optimizer=TO.SGD(0.01),
                  compute_dtype=torch.bfloat16, device="cpu")
    (tloss,) = _port_steps(ttr, [batch])
    own = abs(losses["jax", "bfloat16"] - losses["jax", "float32"])
    assert np.isfinite(tloss)
    assert abs(tloss - losses["jax", "bfloat16"]) <= own, (tloss, losses)
