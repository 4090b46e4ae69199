"""The training path's ops against the JAX package on the CPU: the
gradients of the FPN upsample-add (the port's autograd Function, whose
backward is the transposed resize's plain version here) and of the row
gather, RoIAlign's tie gradients, the 2x bilinear upsample and its VJP, and
every loss of ``ops.losses``.  Seeded numpy inputs go to both; each
tolerance says why."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.ops import image as JI
from tlxcv_tpu.ops import losses as JL
from tlxcv_tpu.ops.pallas.upsample import (upsample2x_bilinear as j_up2x_bl,
                                           upsample2x_fused as j_up2x,
                                           upsample_add_fused as j_up_add)
from tlxcv_tpu.ops.roi_align import multilevel_roi_align as j_mlra
from tlxcv_tpu.ops.roi_align import roi_align as j_roi_align
from tlxcv_tpu_torch.ops import image as TI
from tlxcv_tpu_torch.ops import losses as TL
from tlxcv_tpu_torch.ops.cuda.gather import gather_rows
from tlxcv_tpu_torch.ops.cuda.upsample import (resize_matrix, sep_resize,
                                               sep_taps, upsample2x_bilinear,
                                               upsample2x_fused)
from tlxcv_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align

_UP_SHAPES = [((2, 8, 8, 16), (16, 16)),      # 2x, the FPN step
              ((1, 38, 38, 8), (75, 75)),     # non-integer: ragged taps
              ((1, 5, 6, 3), (11, 13)),       # odd sizes, C = 3
              ((2, 7, 9, 16), (7, 18))]       # one axis unchanged


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs six workers on one host: two torch threads each keep
    them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(fn, *arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn(*ts).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("xshape,out_hw", _UP_SHAPES)
def test_upsample_add_grad_matches_jax(mode, xshape, out_hw):
    """``ops.image.upsample_add``'s gradient against ``jax.vjp`` of the
    Pallas kernel interpreted (``_fused_up_add_bwd``) and of the JAX
    default route, f32.  d_skip is g exactly.  dx: nearest sums g with
    weight 1, exact in any order, so it equals the Pallas VJP bitwise;
    bilinear sums up to 16 weighted taps per output, whose order differs
    (2e-6 against the kernel's dot, 2e-5 against XLA's gather route, for
    g ~ N(0, 1))."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=xshape).astype(np.float32)
    skip = rng.normal(size=(xshape[0], *out_hw, xshape[3])).astype(np.float32)
    g = rng.normal(size=skip.shape).astype(np.float32)
    dx, dskip = _grads(lambda a, b: TI.upsample_add(a, b, mode=mode),
                       x, skip, g=g)
    np.testing.assert_array_equal(dskip, g)
    for fn, atol in (
            (lambda a, b: j_up_add(a, b, mode=mode, interpret=True),
             0.0 if mode == "nearest" else 2e-6),
            (lambda a, b: JI.upsample_add(a, b, mode=mode), 2e-5)):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(skip))
        want_dx, want_dskip = vjp(jnp.asarray(g))
        np.testing.assert_allclose(dx, np.asarray(want_dx), rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(dskip, np.asarray(want_dskip))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("n_out,n_in", [(16, 8), (75, 38), (13, 6), (7, 7)])
def test_sep_taps_are_the_matrix_nonzeros(mode, n_out, n_in):
    """The CSR taps (and their padded copy) rebuild ``_resize_matrix`` and
    its transpose exactly; a transposed nearest 2x row has 2 taps, a
    bilinear one up to 4."""
    for transposed in (False, True):
        a = resize_matrix(n_out, n_in, mode)
        a = a.T if transposed else a
        t = sep_taps(n_out, n_in, mode, transposed, torch.device("cpu"))
        dense = np.zeros_like(a)
        ptr = t.ptr.numpy()
        for r in range(a.shape[0]):
            s = slice(ptr[r], ptr[r + 1])
            np.add.at(dense[r], t.src.numpy()[s], t.weight.numpy()[s])
            assert ptr[r + 1] - ptr[r] == t.count[r]
            k = t.count[r]
            np.testing.assert_array_equal(t.pad_src[r, :k], t.src[s])
        np.testing.assert_array_equal(dense, a)
    if (n_out, n_in) == (16, 8):
        t = sep_taps(16, 8, mode, True, torch.device("cpu"))
        assert int(t.count.max()) == (2 if mode == "nearest" else 4)


def test_sep_resize_takes_stride0_and_permuted_gradients():
    """The gradient autograd hands over after ``.sum()`` is a stride-0
    expand; a permuted one is not contiguous.  Both give the contiguous
    result bitwise (the same taps in the same order)."""
    rng = np.random.default_rng(2)
    th = sep_taps(16, 8, "bilinear", True, torch.device("cpu"))
    tw = sep_taps(20, 10, "bilinear", True, torch.device("cpu"))
    g0 = torch.tensor(1.5).expand(2, 16, 20, 4)
    np.testing.assert_array_equal(
        sep_resize(g0, th, tw).numpy(),
        sep_resize(g0.contiguous(), th, tw).numpy())
    gp = torch.from_numpy(rng.normal(size=(2, 4, 20, 16)).astype(
        np.float32)).permute(0, 3, 2, 1)
    np.testing.assert_array_equal(
        sep_resize(gp, th, tw).numpy(),
        sep_resize(gp.contiguous(), th, tw).numpy())
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 8)).astype(np.float32))
    x.requires_grad_()
    TI.upsample_add(x, torch.zeros(1, 8, 10, 8), mode="bilinear").sum() \
        .backward()
    want = resize_matrix(8, 4).sum(0)[:, None] * resize_matrix(10, 5).sum(0)
    np.testing.assert_allclose(x.grad[0, ..., 0].numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (2, 8, 8, 128)])
def test_upsample2x_matches_both_pallas_kernels(shape):
    """``upsample2x_fused`` / ``upsample2x_bilinear`` against the Pallas
    kernels interpreted (the cases of tests/test_pallas_ops.py), forward
    and ``jax.grad`` of sum(y^2), f32: the same 2-tap sums per axis in
    another order (the kernel's dot) -> 2e-6; the gradient sums up to 16
    taps of 2y -> 2e-5."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = upsample2x_fused(xt)
    (y ** 2).sum().backward()
    assert upsample2x_bilinear is upsample2x_fused
    for fn in (lambda v: j_up2x(v, interpret=True),
               lambda v: j_up2x_bl(v, interpret=True)):
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(fn(jnp.asarray(x))), atol=2e-6)
    want = jax.grad(lambda v: (j_up2x(v, interpret=True) ** 2).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_rows_grad_matches_jax(dtype):
    """The gather's gradient, a scatter-add of g into an f32 zero table,
    against ``jax.vjp`` of ``table[idx]`` with repeated indices.  f32:
    the sums into a repeated row in another order -> 1e-6.  bf16: XLA adds
    in bf16 while the port adds in f32 and rounds once -> within 2 bf16
    steps of the largest sum."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, size=300).astype(np.int32)
    idx[:20] = 7                                       # one row 20+ times
    g = rng.normal(size=(300, 8)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    t = torch.from_numpy(table).to(tdt).requires_grad_()
    out = gather_rows(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g).to(tdt))
    _, vjp = jax.vjp(lambda v: v[jnp.asarray(idx)], jnp.asarray(table, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(want, np.float32)
    got = t.grad.float().numpy()
    assert t.grad.dtype == tdt
    atol = 1e-6 if tdt == torch.float32 else 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_mask_targets_index_the_matched_gt_in_place():
    """``roi_align(..., batch_index=)`` reads each box's own image: the
    same as the reference's copy of the matched masks, then RoIAlign
    (f32 bilinear weights of random coordinates, products taken in
    another order: 1e-5 of the [0, 1] mask values)."""
    rng = np.random.default_rng(5)
    masks = (rng.random(size=(3, 40, 40)) > 0.5).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 20, (6, 2)),
                            rng.uniform(20, 40, (6, 2))], 1).astype(np.float32)
    match = np.asarray([2, 0, 1, 1, 2, 0])
    got = roi_align(torch.from_numpy(masks)[..., None],
                    torch.from_numpy(boxes)[:, None], 14,
                    batch_index=torch.from_numpy(match))[:, 0, ..., 0]
    want = jax.vmap(lambda m, b: j_roi_align(m[None, ..., None],
                                             b[None, None], 14)[0, 0, ..., 0])(
        jnp.asarray(masks[match]), jnp.asarray(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_roi_align_tie_gradients_split_as_in_jax():
    """A box whose one sample lands exactly on the edge clamp (y = x = 0)
    and whose size sits exactly on the 1-pixel floor: JAX's ``clip`` and
    ``maximum`` pass half the gradient at a tie (``clamp`` would pass all
    of it).  The box gradient equals JAX's."""
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(1, 16 // 2 ** i, 16 // 2 ** i, 4)).astype(
        np.float32) for i in range(4)]
    boxes = np.asarray([[[0.0, 0.0, 4.0, 4.0], [2.0, 3.0, 30.0, 40.0]]],
                       np.float32)
    bt = torch.from_numpy(boxes).requires_grad_()
    out = multilevel_roi_align([torch.from_numpy(f) for f in feats], bt, 1, 1)
    g = rng.normal(size=out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda b: j_mlra([jnp.asarray(f) for f in feats], b, 1,
                                      1), jnp.asarray(boxes))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _loss_cases(rng):
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    probs = rng.random(size=(6, 5)).astype(np.float32)
    binary = (rng.random(size=(6, 5)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    pred = rng.normal(size=(6, 4)).astype(np.float32) * 3
    tgt = rng.normal(size=(6, 4)).astype(np.float32) * 3
    xy = rng.uniform(0, 50, size=(6, 2)).astype(np.float32)
    boxes_p = np.concatenate([xy, xy + rng.uniform(5, 30, (6, 2))], 1)
    boxes_t = np.concatenate([xy + 3, xy + rng.uniform(5, 30, (6, 2))], 1)
    return {
        "softmax_cross_entropy": ((logits, labels), {}),
        "softmax_cross_entropy_smoothed": ((logits, labels),
                                           {"label_smoothing": 0.1}),
        "binary_cross_entropy": ((logits, binary), {}),
        "binary_cross_entropy_pos_weight": ((logits, probs),
                                            {"pos_weight": 2.0}),
        "sigmoid_focal_loss": ((logits, binary), {"reduction": "mean"}),
        "varifocal_loss": ((logits, probs, binary), {}),
        "dice_loss": ((logits, binary), {}),
        "smooth_l1_loss": ((pred, tgt), {"beta": 1.0}),
        "l1_loss": ((pred, tgt), {"reduction": "sum"}),
        "mse_loss": ((pred, tgt), {}),
        "wing_loss": ((pred, tgt), {}),
        "giou_loss": ((boxes_p.astype(np.float32),
                       boxes_t.astype(np.float32)), {}),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases(np.random.default_rng(0))))
def test_loss_matches_jax(name):
    """Value and gradient of the first argument, f32: the same elementwise
    formula reduced in another order -> 1e-5 relative (wing loss's
    constant is taken in float64 by the port, in f32 by JAX)."""
    args, kw = _loss_cases(np.random.default_rng(0))[name]
    fn = name.replace("_smoothed", "").replace("_pos_weight", "")
    jv, jg = jax.value_and_grad(
        lambda a, *r: getattr(JL, fn)(a, *r, **kw))(
        *(jnp.asarray(a) for a in args))
    t0 = torch.from_numpy(args[0]).requires_grad_()
    tv = getattr(TL, fn)(t0, *(torch.from_numpy(a) for a in args[1:]), **kw)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t0.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
