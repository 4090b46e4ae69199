"""The port's Swin Transformer and DeiT against the JAX package on the CPU,
with the JAX model's weights copied across by the bridge.

Tolerance: logits within 2e-4 of their largest magnitude, as
``tests/test_parity_resnet.py:91`` bounds f32 modules; packed windows
against unpacked within 2e-5 absolute, 1e-4 relative, as
``tests/test_swin_pack.py`` holds the reference's (cross-window leakage
exp(-100) and another summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification import deit as JD
from tlxcv_tpu.models.classification import swin_transformer as JS
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.classification import deit as TD
from tlxcv_tpu_torch.models.classification import swin_transformer as TS
from tlxcv_tpu_torch.tasks import ImageClassification
from tlxcv_tpu_torch.utils import load_jax_params

SWIN = dict(img_size=56, patch_size=4, num_classes=7, embed_dim=24,
            depths=(2, 2), num_heads=(2, 4), drop_path_rate=0.0)


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _close(got, want, bound=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=bound * np.abs(want).max())


def _swin_pair():
    """The micro Swin of tests/test_swin_pack.py: 56 px / patch 4 -> 14x14
    tokens (4 windows, the shifted block carries a real mask), merged to
    7x7 (1 window: packing pairs windows across images)."""
    jm = JS.SwinTransformer(**SWIN)
    tm = TS.SwinTransformer(**SWIN, device="cpu")
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


@pytest.mark.parametrize("pack", [1, 2])
def test_swin_matches_jax(rng, pack):
    jm, tm = _swin_pair()
    assert tm.stages[0][1].shift == 3 and tm.stages[0][1].attn_mask is not None
    JS.set_window_pack(jm, pack)
    TS.set_window_pack(tm, pack)
    x = rng.normal(size=(4, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        _close(got, want)
        TS.set_window_pack(tm, 1)  # read afresh by every forward
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), got,
                                   atol=2e-5, rtol=1e-4)


def test_swin_pack_falls_back_and_packs_a_raw_mask(rng):
    """A pack that does not divide batch x windows runs unpacked; a direct
    WindowAttention call with the unpacked shift mask packs it itself
    (tests/test_swin_pack.py's cases)."""
    _, tm = _swin_pair()
    x = torch.from_numpy(rng.normal(size=(3, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        ref = tm(x)
        TS.set_window_pack(tm, 8)
        torch.testing.assert_close(tm(x), ref, atol=2e-5, rtol=1e-4)
        blk = tm.stages[0][1]
        w = torch.from_numpy(rng.normal(size=(8, 49, 24)).astype(np.float32))
        TS.set_window_pack(tm, 2)
        torch.testing.assert_close(blk.attn(w, blk.attn_mask),
                                   blk.attn(w, blk.attn_mask, pack=1),
                                   atol=2e-5, rtol=1e-4)


def test_swin_shift_tables_match_jax():
    for h, ws, shift in ((14, 7, 3), (8, 4, 2)):
        np.testing.assert_array_equal(TS._shift_attn_mask(h, h, ws, shift),
                                      JS._shift_attn_mask(h, h, ws, shift))
        np.testing.assert_array_equal(TS._relative_position_index(ws),
                                      JS._relative_position_index(ws))
    x = torch.arange(2 * 14 * 14 * 3, dtype=torch.float32).reshape(
        2, 14, 14, 3)
    w = TS.window_partition(x, 7)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(JS.window_partition(jnp.asarray(x.numpy()), 7)))
    assert torch.equal(TS.window_reverse(w, 7, 14, 14), x)


def test_deit_matches_jax(rng):
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
               num_classes=10)
    jm = JD.deit_base(**cfg)
    tm = TD.deit_base(**cfg, device="cpu")
    load_jax_params(tm, _flat(jm))
    task = ImageClassification(tm).eval()
    assert tm.pos_embed.shape == (1, 16 + 2, 64)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = task(torch.from_numpy(x)).numpy()
        pred = task.predict(torch.from_numpy(x)).numpy()
    _close(got, want)
    np.testing.assert_array_equal(pred, np.asarray(want).argmax(-1))


def test_registry_builds_the_transformers():
    names = set(list_models())
    assert {"deit_tiny", "deit_small", "deit_base", "dvt", "swin_tiny",
            "swin_small", "swin_base", "swin_large",
            "swin_transformer_base"} <= names
    assert "set_window_pack" not in names
    deit = create_model("deit_base", depth=1, device="cpu")
    assert deit.blocks[0].attn.num_heads == 12 and deit.embed_dim == 768
    swin = create_model("swin_base", img_size=56, device="cpu")
    assert swin.num_features == 1024 and len(swin.stages[2]) == 18
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_model("swin_base")
        with pytest.raises(RuntimeError):
            create_model("deit_base", depth=1)
