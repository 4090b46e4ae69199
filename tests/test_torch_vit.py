"""The port's ViT classification slice against the JAX package on the CPU:
a micro ViT and ViT-B/16 at full width (depth cut to 2), with the JAX
model's weights copied across by the bridge."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification import vision_transformer as JV
from tlxcv_tpu.ops.losses import softmax_cross_entropy as jax_ce
from tlxcv_tpu.tasks import ImageClassification as JaxTask
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.classification import vision_transformer as TV
from tlxcv_tpu_torch.ops.losses import softmax_cross_entropy
from tlxcv_tpu_torch.tasks import ImageClassification
from tlxcv_tpu_torch.utils import load_jax_params


def _bridged(jax_model, torch_model):
    params, state = split(jax_model)
    flat = {p: np.asarray(a) for p, a in {**params, **state}.items()}
    load_jax_params(torch_model, flat)
    return ImageClassification(torch_model).eval()


def _compare(jax_model, torch_task, x):
    params, state = split(jax_model)
    want, _ = pure(jax_model)(params, state, jnp.asarray(x))
    want_pred, _ = pure(JaxTask(jax_model), "predict")(
        *split(JaxTask(jax_model)), jnp.asarray(x))
    with torch.no_grad():
        got = torch_task(torch.from_numpy(x))
        got_pred = torch_task.predict(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))


def test_micro_vit_matches_jax(rng):
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
               num_classes=10, qkv_bias=True)
    jm = JV.VisionTransformer(**cfg)
    task = _bridged(jm, TV.VisionTransformer(**cfg, device="cpu"))
    _compare(jm, task, rng.normal(size=(4, 32, 32, 3)).astype(np.float32))


def test_vit_b16_full_width_matches_jax(rng):
    """197 tokens, head dim 64, width 768, 1000 classes; depth cut to 2."""
    jm = JV.vit_base_patch16_224(depth=2)
    task = _bridged(jm, create_model("vit_base_patch16_224", depth=2,
                                     device="cpu"))
    _compare(jm, task, rng.normal(size=(1, 224, 224, 3)).astype(np.float32))


def test_create_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; create_model() would use it")
    with pytest.raises(RuntimeError):
        create_model("vit_base_patch16_224", depth=1)
    with pytest.raises(RuntimeError):
        TV.VisionTransformer(depth=1)


def test_registry_holds_the_vit_factories():
    names = [n for n in list_models("vit_") if n.startswith("vit_")]
    assert names == sorted(JV.__all__[1:])  # not LeViT's levit_*
    with pytest.raises(KeyError):
        create_model("vit_nonexistent", device="cpu")
    small = create_model("vit_small_patch16_224", depth=1, device="cpu")
    assert small.blocks[0].attn.scale == 768 ** -0.5  # not head_dim ** -0.5
    assert small.blocks[0].attn.head_dim == 96


@pytest.mark.parametrize("labels_kind,kw", [
    ("int", {}),
    ("int", {"label_smoothing": 0.1}),
    ("onehot", {}),
    ("onehot", {"reduction": "sum"}),
    ("int", {"reduction": "none"}),
])
def test_loss_matches_jax(rng, labels_kind, kw):
    logits = rng.normal(size=(8, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, size=8).astype(np.int32)
    if labels_kind == "onehot":
        labels = np.eye(10, dtype=np.float32)[labels]
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), **kw)
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_task_loss_fn_matches_jax(rng):
    logits = rng.normal(size=(6, 1000)).astype(np.float32)
    labels = rng.integers(0, 1000, size=6).astype(np.int64)
    want = JaxTask(None).loss_fn(jnp.asarray(logits), jnp.asarray(labels))
    got = ImageClassification(torch.nn.Identity()).loss_fn(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)


def test_loss_class_axis_matches_jax(rng):
    logits = rng.normal(size=(2, 5, 4, 4)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 4, 4))]
    labels = np.moveaxis(labels, -1, 1)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), axis=1)
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
