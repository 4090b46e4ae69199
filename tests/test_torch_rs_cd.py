"""The port's change detectors (FC-EF, CDNet, SNUNet, DSIFN, STANet with
BAM and PAM, DSAMNet, FCCDN at output strides 16, 8 and 4) and PReLU
against the JAX package on the CPU, in eval and, where the reference
returns more in training, in train mode.

Micro size, the JAX package's own (``tests/test_rs.py``): 64 px pairs,
SNUNet at width 4, the others at their published widths.  Weights are
the JAX model's, copied by the bridge; BatchNorm statistics are drawn from
a numpy seed.  The JAX side runs under ``jax.jit`` (its eager dispatch
compiles op by op and takes several times as long).

Tolerance: f32 outputs within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); in train mode dropout is 0 in both
and BatchNorm takes the batch's statistics in both.  STANet's attention
convs (q and k) are drawn at a tenth of their init: at init its attention
logits reach about 10^3 (random weights, random statistics), where one
rounding of q moves the softmax by 1e-4 of the output, in either package
(f32 against float64 on the same weights: the JAX package 2.9e-5 to
2.2e-4 of the largest magnitude, the port 8e-5 to 6.3e-4).

FCCDN in train mode normalises its centre by the batch's statistics over
a few positions (two at 64 px and b2, where either package's f32 model
lies 2.4e-2 of the largest magnitude from its float64 one), and the error
grows through its difference streams: at 128 px b2 both packages' f32
outputs lie 1e-4 to 2.1e-4 from the float64 model at most, and within
2.1e-5 of its largest magnitude in rms (seeds 0 to 3).  There each output
is held to the JAX package twice: the JAX package's f32 output within
1e-4 of the largest magnitude in rms of the port's float64 model, and the
port's f32 output within the same of the JAX package's; and, as the
card's chaotic models are held, the port's rms error against its float64
model within twice the JAX package's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seg_zoo import _check, _close, _flat, _no_dropout
from tests.test_torch_seg_zoo import _random_bn
from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.rs import cd as JCD
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.rs import cd as TCD
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.utils import load_jax_params

CD = [("fc_ef", "FCEarlyFusion", {}), ("cdnet", "CDNet", {}),
      ("snunet", "SNUNet", {"width": 4}), ("dsifn", "DSIFN", {}),
      ("stanet_bam", "STANet", {}),
      ("stanet_pam", "STANet", {"att_type": "PAM"}),
      ("dsamnet", "DSAMNet", {}), ("fccdn", "FCCDN", {}),
      ("fccdn_os8", "FCCDN", {"os": 8}), ("fccdn_os4", "FCCDN", {"os": 4})]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _tame_attention(jm):
    """STANet's q and k convs at a tenth of their init (module docstring)."""
    for path, mod in jm.modules():
        if path.rsplit("/", 1)[-1] in ("conv_q", "conv_k"):
            mod.conv.weight.value = mod.conv.weight.value * 0.1


def _pair(cls, kw, rng):
    jm = getattr(JCD, cls)(3, 2, **kw)
    _random_bn(jm, rng)
    if cls == "STANet":
        _tame_attention(jm)
    tm = getattr(TCD, cls)(3, 2, device="cpu", **kw)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def _images(rng, hw=64, n=2):
    return [rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
            for _ in range(2)]


def _run(jm, tm, t1, t2, training=False):
    if training:
        _no_dropout(jm, tm)
        tm.train()
    fwd = jax.jit(lambda p, s, a, b: pure(jm)(p, s, a, b,
                                              training=training)[0])
    want = fwd(*split(jm), jnp.asarray(t1), jnp.asarray(t2))
    with torch.no_grad():
        got = tm(torch.from_numpy(t1), torch.from_numpy(t2))
    return got, want


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


@pytest.mark.parametrize("name,cls,kw", CD, ids=[c[0] for c in CD])
def test_change_detector_matches_jax(rng, name, cls, kw):
    jm, tm = _pair(cls, kw, rng)
    got, want = _run(jm, tm, *_images(rng))
    assert got.shape == (2, 64, 64, 2)
    _check(got, want)


# the deep-supervision outputs in train mode: (model, frame, outputs, their
# shapes); STANet returns its one output, through train-mode BatchNorm
TRAIN = [("DSIFN", 64, 5, [(2, 64, 64, 2)] * 5),
         ("DSAMNet", 64, 3, [(2, 64, 64, 2)] * 3),
         ("FCCDN", 128, 3, [(2, 128, 128, 2), (2, 64, 64, 1),
                            (2, 64, 64, 1)]),
         ("STANet", 64, 1, [(2, 64, 64, 2)])]


@pytest.mark.parametrize("cls,hw,n_out,shapes", TRAIN,
                         ids=[t[0] for t in TRAIN])
def test_training_outputs_match_jax(rng, cls, hw, n_out, shapes):
    jm, tm = _pair(cls, {}, rng)
    t1, t2 = _images(rng, hw)
    truth = copy.deepcopy(tm).double().train()
    got, want = _run(jm, tm, t1, t2, training=True)
    if n_out == 1:
        got, want = [got], [want]
    assert len(got) == len(want) == n_out
    assert [tuple(g.shape) for g in got] == shapes
    if cls != "FCCDN":
        _check(got, want)
        return
    with torch.no_grad():
        exact = truth(torch.from_numpy(t1).double(),
                      torch.from_numpy(t2).double())
    for g, w, e in zip(got, want, exact):
        scale = float(e.abs().max())
        assert _rms(w, e) <= 1e-4 * scale
        assert _rms(g, w) <= 1e-4 * scale
        assert _rms(g, e) <= 2 * _rms(w, e)


def test_fccdn_aux_heads_are_each_dates(rng):
    """FCCDN's two auxiliary heads read the two dates' decoders: swapping
    the dates swaps them."""
    tm = TCD.FCCDN(3, 2, device="cpu").train()
    a, b = (torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        _, s1, s2 = tm(a, b)
        _, r1, r2 = tm(b, a)
    torch.testing.assert_close(s1, r2)
    torch.testing.assert_close(s2, r1)
    assert not torch.allclose(s1, s2)


@pytest.mark.parametrize("block", ["BAM", "PAM"])
def test_attention_blocks_downsampled_match_jax(rng, block):
    """BAM and PAM with ``ds`` 2: average-pooled, attended, resized back
    by nearest; PAM at scales 1, 2 and 4 on a 8 x 16 map."""
    kw = {"ds": 2} if block == "BAM" else {"ds": 2, "scales": (1, 2, 4)}
    jm = getattr(JCD, block)(16, **kw)
    _random_bn(jm, rng)
    tm = getattr(TCD, block)(16, device="cpu", **kw)
    load_jax_params(tm, _flat(jm))
    x = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
    want = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got, want)


def test_st_attention_interleaves_the_dates_along_the_width():
    """Column 2j of the attended map is t1's column j and 2j + 1 is t2's,
    not a concatenation; the two come back apart."""
    seen = []

    def att(x):
        seen.append(x)
        return x

    x1, x2 = torch.randn(1, 3, 4, 5), torch.randn(1, 3, 4, 5)
    y1, y2 = TCD._STAttention(att)(x1, x2)
    assert torch.equal(seen[0][:, :, 0::2], x1)
    assert torch.equal(seen[0][:, :, 1::2], x2)
    assert torch.equal(y1, x1) and torch.equal(y2, x2)


def test_vgg16_picker_takes_the_reference_indices(rng):
    """DSIFN's trunk: the ReLU outputs at indices 3, 8, 15, 22 and 29, at
    strides 1 to 16."""
    tm = TCD.VGG16FeaturePicker(device="cpu")
    assert len(tm.features) == 30
    assert all(type(tm.features[i]).__name__ == "Activation"
               for i in (3, 8, 15, 22, 29))
    with torch.no_grad():
        feats = tm(torch.randn(1, 32, 32, 3))
    assert [tuple(f.shape) for f in feats] == [
        (1, 32, 32, 64), (1, 16, 16, 128), (1, 8, 8, 256), (1, 4, 4, 512),
        (1, 2, 2, 512)]


@pytest.mark.parametrize("num_parameters", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_matches_jax(rng, num_parameters, dtype):
    jm = jnn.PReLU(num_parameters)
    jm.weight.value = jnp.asarray(rng.uniform(-0.5, 0.5, num_parameters),
                                  jnp.float32)
    tm = T.PReLU(num_parameters, device="cpu")
    load_jax_params(tm, _flat(jm))
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.detach().float().numpy(), want)


def test_registry_builds_the_change_detectors():
    snunet = create_model("snunet", device="cpu")
    assert type(snunet).__name__ == "SNUNet"
    assert snunet.conv0_0.conv1.weight.shape[0] == 32  # width 32
    fc_ef = create_model("fc_ef", device="cpu", num_classes=3).eval()
    with torch.no_grad():
        out = fc_ef(torch.randn(1, 32, 32, 3), torch.randn(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("snunet")
