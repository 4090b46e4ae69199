"""The port's attention classifiers (TNT, PP-HGNet, PVTv2, Twins PCPVT and
SVT, CSWin, LeViT) against the JAX package on the CPU, and their helpers
each on its own: LeViT's offset table and CSWin's stripes.

Micro size, the JAX package's own (``tests/test_classifiers.py:10-74``):
``tnt_micro``, ``pvt_v2_b0``, ``pcpvt_micro``, ``twins_micro`` and
``levit_micro`` at 64 px, ``cswin_micro`` at 112, PP-HGNet-small at 64;
10 classes, b2.  Weights are the JAX model's, copied by the bridge, after
the parameters that start at or near zero are drawn at O(1) from a numpy
seed (at init they would hide the paths they scale): every BatchNorm's
statistics and affine (LeViT's zero-started ``bn_weight_init=0`` ones
among them), LeViT's attention biases, ConvNeXt's and VAN's layer scales,
TNT's position embeddings and class token.  The JAX side runs under
``jax.jit``, one build per model.

Tolerance: logits in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); the bridge's keys, the offset table
and the stripes exactly.
"""
import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu.config import create_model as jax_create_model
from tlxcv_tpu.core import pure, split
from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core.module import Param
from tlxcv_tpu.models import classification as JC
from tlxcv_tpu.models.classification import cswin as JCS
from tlxcv_tpu.models.classification import levit as JL
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models import classification as TC
from tlxcv_tpu_torch.models.classification import cswin as TCS
from tlxcv_tpu_torch.models.classification import levit as TL
from tlxcv_tpu_torch.utils import load_jax_params

# parameters that start at zero or near it, and the std they are drawn at
DRAWN = {"gamma": 0.5, "ls1": 0.5, "ls2": 0.5, "attention_biases": 1.0,
         "pixel_pos": 0.5, "patch_pos": 0.5, "cls_token": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def draw_small_starts(jm, rng):
    """BatchNorm statistics and affine, and the ``DRAWN`` parameters
    (a layer scale around 1), drawn from ``rng`` on the JAX model."""
    _random_bn(jm, rng)
    for _, mod in jm.modules():
        for name, std in DRAWN.items():
            p = getattr(mod, name, None)
            if isinstance(p, Param):
                shift = 1.0 if name in ("gamma", "ls1", "ls2") else 0.0
                p.value = jnp.asarray(
                    shift + rng.normal(scale=std, size=p.value.shape),
                    jnp.float32)


def bn_statistics_from_data(jm, x):
    """Every BatchNorm's running statistics replaced by those of its own
    input in one train-mode forward of ``x`` (momentum 0), so that each
    normalises its input to mean 0 and variance 1."""
    bns = [m for _, m in jm.modules() if isinstance(m, jnn.BatchNorm)]
    kept = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    params, state = split(jm)
    _, state = pure(jm)(params, state, jnp.asarray(x), training=True)
    for m, v in zip(bns, kept):
        m.momentum = v
    jm.load_state_dict({**params, **state})


def bridged_pair(jf, tf, rng, size=None, prepare=None):
    """The JAX model with its small starts drawn (then ``prepare(jm)``),
    and the port's built by ``tf`` with its weights, in eval mode.  With
    ``size``, the BatchNorm statistics come from a forward of two images
    of that side instead."""
    jm = jf()
    draw_small_starts(jm, rng)
    if prepare is not None:
        prepare(jm)
    if size is not None:
        bn_statistics_from_data(jm, rng.normal(size=(2, size, size, 3)))
    tm = tf()
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def run_jax(jm, x, training=False):
    out, _ = jax.jit(lambda p, s, v: pure(jm)(p, s, v, training=training))(
        *split(jm), jnp.asarray(x))
    return out


def check_logits(jm, tm, x):
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = np.asarray(run_jax(jm, x))
    assert np.isfinite(want).all() and np.isfinite(got.numpy()).all()
    _close(got, want)
    return want


def check_bridge_keys(jm, tm):
    """Every JAX leaf is one key of the port's state_dict, and every key
    one JAX leaf."""
    assert set(k.replace("/", ".") for k in _flat(jm)) == set(tm.state_dict())


def check_registry_builds(name):
    """``create_model`` builds the factory on the CPU under the JAX name,
    with the JAX model's parameter count."""
    model = create_model(name, device="cpu", num_classes=10)
    assert next(model.parameters()).device.type == "cpu"
    flat = _flat(jax_create_model(name, num_classes=10))
    assert sum(p.numel() for p in model.state_dict().values()) == sum(
        a.size for a in flat.values())


def pairs_fixture(models, bn_from_data=(), prepare=None):
    """A module-scoped cache of bridged (JAX, port) pairs by name; the
    models named in ``bn_from_data`` take their BatchNorm statistics from
    data, those in ``prepare`` are handed to its function first."""
    cache = {}

    def get(name):
        if name not in cache:
            jf, tf, size = models[name]
            cache[name] = bridged_pair(
                jf, tf, np.random.default_rng(list(models).index(name) + 17),
                size if name in bn_from_data else None,
                (prepare or {}).get(name))
        return cache[name]
    return get


def _pair(name, **kw):
    """(JAX factory, port factory) of one class or factory name, both at
    ``kw`` and 10 classes."""
    return (lambda: getattr(JC, name)(num_classes=10, **kw),
            lambda: getattr(TC, name)(num_classes=10, device="cpu", **kw))


TNT_MICRO = dict(img_size=64, depth=1, outer_dim=32, inner_dim=8,
                 outer_heads=2, inner_heads=2)
PYRAMID_MICRO = dict(embed_dims=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
                     mlp_ratios=(4, 4, 4, 4), sr_ratios=(8, 4, 2, 1))
LEVIT_MICRO = dict(img_size=64, embed_dim=(32, 64, 96), key_dim=(8, 8, 8),
                   depth=(1, 1, 1), num_heads=(2, 2, 2), distillation=True)

MODELS = {
    "tnt_micro": (*_pair("TNT", **TNT_MICRO), 64),
    "pp_hgnet_small": (*_pair("pp_hgnet_small"), 64),
    "pvt_v2_b0": (*_pair("pvt_v2_b0"), 64),
    "pcpvt_micro": (*_pair("CPVTV2", depths=(1, 1, 1, 1),
                           **PYRAMID_MICRO), 64),
    "twins_micro": (*_pair("ALTGVT", depths=(1, 1, 2, 1),
                           wss=(2, 2, 2, 2), **PYRAMID_MICRO), 64),
    "cswin_micro": (*_pair("CSWinTransformer", img_size=112,
                           embed_dim=32, depths=(1, 1, 2, 1),
                           heads=(2, 2, 4, 8), split_sizes=(1, 2, 7, 4)),
                    112),
    "levit_micro": (*_pair("LeViT", **LEVIT_MICRO), 64),
}


@pytest.fixture(scope="module")
def pairs():
    return pairs_fixture(MODELS)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(rng, pairs, name):
    jm, tm = pairs(name)
    size = MODELS[name][2]
    check_logits(jm, tm, rng.normal(size=(2, size, size, 3)).astype(
        np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_fills_every_key(pairs, name):
    check_bridge_keys(*pairs(name))


def test_levit_distillation_heads_in_train_mode(rng, pairs):
    """Train mode returns both heads' logits, with BatchNorm on the batch's
    statistics; eval mode their mean (``test_logits_match_jax``).  At b8:
    the heads' BatchNorm normalises one vector an image, and over two
    images its statistics are ill-conditioned in both packages."""
    jm, tm = pairs("levit_micro")
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    want = run_jax(jm, x, training=True)
    model = copy.deepcopy(tm).train()  # train mode updates the statistics
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("res,res_out,stride", [(4, 4, 1), (4, 2, 2),
                                                (7, 4, 2), (14, 7, 2)])
def test_levit_offset_table_is_the_references(res, res_out, stride):
    grid = lambda r: list(itertools.product(range(r), range(r)))  # noqa
    got = TL._offset_table(grid(res_out), grid(res), stride)
    want = JL._offset_table(grid(res_out), grid(res), stride)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1]


def test_levit_bias_gathers_match_jax(pairs):
    """Each attention's [H, Nq, Nk] bias, gathered from its drawn table by
    the static offset ids, is the JAX model's: the blocks' and the two
    subsampling transitions' (Nq = Nk / 4)."""
    jm, tm = pairs("levit_micro")
    shapes = []
    for jb, tb in zip(jm.blocks, tm.blocks):
        ja, ta = getattr(jb, "m", jb), getattr(tb, "m", tb)
        if not hasattr(ta, "attention_biases"):
            continue
        want = np.asarray(ja.attention_biases.value)[:, ja._bias_idxs]
        got = ta.attention_biases[:, ta.bias_idxs].detach().numpy()
        np.testing.assert_array_equal(got, want)
        shapes.append(got.shape)
    assert shapes == [(2, 16, 16), (4, 4, 16), (2, 4, 4), (8, 1, 4),
                      (2, 1, 1)]


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("split_size", [1, 2, 7])
def test_cswin_stripes_invert_and_match_jax(rng, horizontal, split_size):
    h, w, c = 14, 14, 6
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    ta = TCS.LePEAttention(c, 2, split_size, horizontal, device="cpu")
    ja = JCS.LePEAttention(c, 2, split_size, horizontal)
    stripes = ta._stripes(torch.from_numpy(x), h, w)
    np.testing.assert_array_equal(
        stripes.numpy(), np.asarray(ja._stripes(jnp.asarray(x), h, w)))
    assert torch.equal(ta._unstripes(stripes, 2, h, w), torch.from_numpy(x))


@pytest.mark.parametrize("name", ["tnt_s", "pp_hgnet_small", "pp_hgnet",
                                  "pvt_v2_b0", "pvt_v2_b1", "pvt_v2_b2",
                                  "pcpvt_small", "pcpvt_base", "pcpvt_large",
                                  "alt_gvt_small", "alt_gvt_base",
                                  "alt_gvt_large", "gvt_small", "cswin_tiny",
                                  "cswin_small", "levit_128s", "levit_128",
                                  "levit_192", "levit_256", "levit_384"])
def test_registry_builds(name):
    check_registry_builds(name)
