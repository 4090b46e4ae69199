"""The port's SE-ResNeXt, ResNeSt, Res2Net and RegNet against the JAX
package on the CPU, and their helpers each on its own: RegNet's widths
and ResNeSt's radix softmax.

The depth-50 models at their full width, b1 64 px (the JAX package's
own micro sizes, ``tests/test_classifiers.py:10-74``); RegNetX and
RegNetY at their published width rules with ``depth`` cut to 8; 10
classes.  Weights are the JAX model's, copied by the bridge, every
BatchNorm's statistics and affine drawn from a numpy seed first
(``tests/test_torch_cls_attention.py``).  The JAX side runs under
``jax.jit``.

Tolerance: logits in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``), the radix softmax within 1e-6 (f32
exp and sum in another order); the widths and the bridge's keys exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import (_few_threads, _pair,  # noqa
                                            check_bridge_keys, check_logits,
                                            check_registry_builds,
                                            pairs_fixture)
from tests.test_torch_seg_zoo import _close
from tlxcv_tpu.models.classification import regnet as JR
from tlxcv_tpu_torch.models.classification import regnet as TR
from tlxcv_tpu_torch.models.classification.se_resnext import radix_softmax

REGNETX = dict(w_a=38.65, w_0=96, w_m=2.43, group_width=40)
REGNETY = dict(w_a=31.41, w_0=96, w_m=2.24, group_width=64, se_ratio=0.25)

MODELS = {
    "se_resnext50_32x4d": (*_pair("se_resnext50_32x4d"), 64),
    "resnest50": (*_pair("resnest50"), 64),
    "res2net50_26w_4s": (*_pair("res2net50_26w_4s"), 64),
    "regnetx_depth8": (*_pair("RegNet", depth=8, **REGNETX), 64),
    "regnety_depth8": (*_pair("RegNet", depth=8, **REGNETY), 64),
}


@pytest.fixture(scope="module")
def pairs():
    return pairs_fixture(MODELS)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(rng, pairs, name):
    jm, tm = pairs(name)
    size = MODELS[name][2]
    check_logits(jm, tm, rng.normal(size=(1, size, size, 3)).astype(
        np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_fills_every_key(pairs, name):
    check_bridge_keys(*pairs(name))


@pytest.mark.parametrize("cfg", [
    dict(w_a=38.65, w_0=96, w_m=2.43, depth=23),   # RegNetX-4GF
    dict(w_a=31.41, w_0=96, w_m=2.24, depth=22),   # RegNetY-4GF
    dict(w_a=38.65, w_0=96, w_m=2.43, depth=8),
    dict(w_a=24.48, w_0=24, w_m=2.54, depth=13),   # RegNetX-200MF
    dict(w_a=106.23, w_0=200, w_m=2.48, depth=18)])  # RegNetX-6.4GF
def test_regnet_widths_are_the_references(cfg):
    got = TR._generate_widths(**cfg)
    assert got == JR._generate_widths(**cfg)
    assert all(type(w) is int for w in got[0] + got[1])


def test_radix_softmax_matches_jax(rng):
    """The attention [B, 1, 1, radix * ch] read as (radix, ch), softmax
    over the radix; the transposed reading gives other weights."""
    att = rng.normal(size=(3, 1, 1, 2 * 5)).astype(np.float32)
    want = jax.nn.softmax(jnp.asarray(att).reshape(3, 1, 1, 2, 5), axis=3)
    got = radix_softmax(torch.from_numpy(att), 2, 5)
    _close(got, want, bound=1e-6)
    wrong = torch.softmax(torch.from_numpy(att).reshape(3, 1, 1, 5, 2), -1)
    assert not torch.allclose(wrong.transpose(3, 4), got)


@pytest.mark.parametrize("name", ["se_resnext50_32x4d", "resnest50",
                                  "res2net50_26w_4s", "res2net101_26w_4s",
                                  "regnetx_4gf", "regnety_4gf"])
def test_registry_builds(name):
    check_registry_builds(name)
