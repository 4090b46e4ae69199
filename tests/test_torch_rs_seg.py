"""The port's remote-sensing segmentation (FarSeg with either scene
projection, its FPN, relation module and asymmetric decoder, and the
PaddleRS UNet) against the JAX package on the CPU, and the ``farseg``
registry name.

Micro size, the JAX package's own (``tests/test_rs.py``): 64 px images,
FarSeg on ResNet-18, RSUNet at width 8.  Weights are the JAX model's,
copied by the bridge (FarSeg's decoder keeps its convs in a list of
lists); BatchNorm statistics are drawn from a numpy seed.

Tolerance: f32 outputs within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.rs import seg as JS
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models import rs as TRS
from tlxcv_tpu_torch.models.rs import seg as TS
from tlxcv_tpu_torch.models.segmentation import deeplab
from tlxcv_tpu_torch.utils import load_jax_params


def _pair(jm, tm, rng):
    _random_bn(jm, rng)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def _jit(jm, x):
    return jax.jit(lambda p, s, v: pure(jm)(p, s, v)[0])(*split(jm),
                                                          jnp.asarray(x))


@pytest.mark.parametrize("scale_aware", [True, False])
def test_farseg_matches_jax(rng, scale_aware):
    kw = dict(num_classes=5, backbone_depth=18, scale_aware_proj=scale_aware)
    jm, tm = _pair(JS.FarSeg(**kw), TS.FarSeg(device="cpu", **kw), rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = _jit(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 5)
    _close(got, want)
    assert len(tm.decoder.blocks) == 4
    assert [len(b) for b in tm.decoder.blocks] == [1, 1, 2, 3]


def test_farseg_fpn_at_non_integer_ratios(rng):
    """The FPN's top-down path takes the legacy nearest rule, floor(i · in
    / out), where the levels' sizes are not in a 2:1 ratio."""
    jm, tm = _pair(JS.FPN([4, 6, 8, 10], 8),
                   TS.FPN([4, 6, 8, 10], 8, device="cpu"), rng)
    feats = [rng.normal(size=(2, s, s + 2, c)).astype(np.float32)
             for s, c in ((13, 4), (7, 6), (5, 8), (3, 10))]
    want = jm([jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats])
    for g, w in zip(got, want):
        _close(g, w)


def test_rsunet_matches_jax(rng):
    jm, tm = _pair(JS.RSUNet(3, 2, width=8),
                   TS.RSUNet(3, 2, width=8, device="cpu"), rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = _jit(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 2)
    _close(got, want)


def test_rs_exports_the_reference_names():
    from tlxcv_tpu.models import rs as JRS

    ref = {n for n in dir(JRS) if not n.startswith("_")
           and n[0].isupper()}
    assert ref <= set(TRS.__all__)
    assert TS.DeepLabV3P is deeplab.DeepLabV3P


def test_registry_builds_farseg():
    tm = create_model("farseg", device="cpu")
    assert type(tm).__name__ == "FarSeg"
    assert tm.cls_head.weight.shape[0] == 16       # iSAID's 15 + background
    assert tm.encoder.feat_channels == [256, 512, 1024, 2048]  # ResNet-50
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("farseg")
