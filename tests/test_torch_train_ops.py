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
from tlxcv_tpu_torch.ops.cuda import upsample as up
from tlxcv_tpu_torch.ops.cuda.upsample import (resize_matrix, sep_resize,
                                               sep_resize_plain, sep_taps,
                                               upsample2x_bilinear,
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


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 8), (2, 8, 8, 128),               # tests/test_pallas_ops.py
    (1, 1, 1, 8), (1, 2, 2, 8), (2, 3, 5, 4),    # the 2x taps' edge sizes
    (1, 4, 1, 3), (2, 2, 7, 5)])
def test_upsample2x_matches_both_pallas_kernels(shape):
    """``upsample2x_fused`` / ``upsample2x_bilinear`` against the Pallas
    kernels interpreted, forward and ``jax.grad`` of sum(y^2), f32, at the
    reference tests' cases and at the sizes where the 2x taps have edges
    (H or W of 1, 2 and 3; the first and last output rows take one tap of
    weight 1, a transposed edge row 3 taps, a size-1 one 2): the same 2-tap
    sums per axis in another order (the kernel's dot) -> 2e-6; the gradient
    sums up to 16 taps of 2y -> 2e-5.  The gradient is held against
    ``upsample2x_fused``'s VJP: ``upsample2x_bilinear``'s bare pallas_call
    has none in JAX."""
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


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 40, 80, 97])
def test_the_2x_kernels_taps_are_the_resize_matrix(n):
    """The taps that ``csrc/upsample2x.cu`` works out from the output index
    (``_rule_2x``) are ``resize_matrix(2n, n)``, which the plain version
    reads: one tap of weight 1 on the first and last output rows, 0.25 and
    0.75 elsewhere.  The wrapper checks it once per size."""
    np.testing.assert_array_equal(up._rule_2x(n),
                                  resize_matrix(2 * n, n, "bilinear"))
    up._check_2x_taps(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1, 1, 3), (1, 3, 2, 8), (2, 5, 7, 4)])
def test_upsample2x_plain_is_sep_resize_plain_on_the_2x_taps(dtype, shape):
    """The 2x kernels' plain versions, forward and VJP, are
    ``sep_resize_plain`` on the 2x bilinear taps and their transposes,
    bitwise, and the wrappers give them for CPU tensors: a stride-0 g (from
    ``.sum()``) and a permuted one give the contiguous result."""
    rng = np.random.default_rng(4)
    n, h, w, c = shape
    cpu = torch.device("cpu")
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(n, 2 * h, 2 * w, c)).astype(
        np.float32)).to(dtype)
    want = sep_resize_plain(x, sep_taps(2 * h, h, "bilinear", False, cpu),
                            sep_taps(2 * w, w, "bilinear", False, cpu))
    assert torch.equal(up.upsample2x_plain(x), want)
    assert torch.equal(upsample2x_fused(x), want)
    want = sep_resize_plain(g, sep_taps(2 * h, h, "bilinear", True, cpu),
                            sep_taps(2 * w, w, "bilinear", True, cpu))
    assert torch.equal(up.upsample2x_vjp_plain(g), want)
    assert torch.equal(up.upsample2x_vjp(g), want)
    gp = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(up.upsample2x_vjp(gp), want)
    g0 = torch.tensor(1.5, dtype=dtype).expand(n, 2 * h, 2 * w, c)
    assert torch.equal(up.upsample2x_vjp(g0),
                       up.upsample2x_vjp(g0.contiguous()))


def test_upsample2x_refuses_what_its_kernels_do_not_take():
    """NHWC f32 or bf16 only, a VJP input of even height and width, and a
    tensor on the CPU or a CUDA device."""
    for bad in (torch.zeros(2, 4, 4), torch.zeros(1, 2, 2, 3,
                                                  dtype=torch.float16)):
        with pytest.raises(ValueError):
            upsample2x_fused(bad)
        with pytest.raises(ValueError):
            up.upsample2x_vjp(bad)
    with pytest.raises(ValueError, match="2H, 2W"):
        up.upsample2x_vjp(torch.zeros(1, 3, 4, 2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        upsample2x_fused(torch.zeros(1, 2, 2, 3, device="meta"))


def _bf16_bound(*arrays):
    """2^-5 of the largest magnitude: a few bf16 ulps at the top of the
    range, as ``tests/test_torch_detection_ops.py`` bounds bf16 resizes."""
    return 2.0 ** -5 * max(np.abs(a).max() for a in arrays)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("xshape,out_hw", _UP_SHAPES)
def test_bf16_upsample_add_rounding_is_a_documented_divergence(
        mode, xshape, out_hw):
    """bf16 ``upsample_add`` forward and x-gradient: the port sums in f32
    and rounds once.  The reference has no single bf16 answer: its default
    XLA route and its Pallas kernel (interpreted; it rounds between its
    two passes, and ``_fused_up_add_bwd`` likewise) round at other places
    and disagree with each other on the gradient wherever an input
    gathers more than two g values (a sum of two bf16 values is exact in
    f32, so one rounding or one per add agree there).  So the port is held
    within 2^-5 of the largest magnitude of each route, the gradient's
    bound taken over g; the nearest forward, one tap plus skip, is
    bitwise.  No per-element ulp bound: outputs near zero differ by many
    of their own ulps on either route, by cancellation."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=xshape).astype(np.float32)
    skip = rng.normal(size=(xshape[0], *out_hw, xshape[3])).astype(np.float32)
    g = rng.normal(size=skip.shape).astype(np.float32)
    xb, sb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, skip, g))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = TI.upsample_add(xt, torch.from_numpy(skip).bfloat16(), mode=mode)
    out.backward(torch.from_numpy(g).bfloat16())
    got, got_dx = _f32(out.detach()), _f32(xt.grad)
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    routes = {"xla": lambda a, b: JI.upsample_add(a, b, mode=mode),
              "pallas": lambda a, b: j_up_add(a, b, mode=mode,
                                              interpret=True)}
    dx = {}
    for name, fn in routes.items():
        want, vjp = jax.vjp(fn, xb, sb)
        dx[name] = _f32(vjp(gb)[0])
        if mode == "nearest":
            np.testing.assert_array_equal(got, _f32(want))
        else:
            np.testing.assert_allclose(got, _f32(want), rtol=0,
                                       atol=_bf16_bound(x, got))
        np.testing.assert_allclose(got_dx, dx[name], rtol=0,
                                   atol=_bf16_bound(g))
    ah, aw = (resize_matrix(o, i, mode) != 0
              for o, i in zip(out_hw, xshape[1:3]))
    gathered = ah.sum(0).max() * aw.sum(0).max()  # g values per input
    assert np.array_equal(dx["xla"], dx["pallas"]) == (gathered <= 2)


@pytest.mark.parametrize("xshape", [s for s, _ in _UP_SHAPES])
def test_bf16_upsample2x_rounding_is_a_documented_divergence(xshape):
    """bf16 2x bilinear forward: the port's ``upsample2x_fused`` and
    ``upsample2x_bilinear`` (one function, rounded once) within 2^-5 of
    the largest magnitude of each reference route: ``interpolate``'s XLA
    route, ``upsample2x_fused``'s Pallas kernel (bf16 weights, rounded
    between its passes) and ``upsample2x_bilinear``'s (bf16 op by op)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=xshape).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    oh, ow = 2 * xshape[1], 2 * xshape[2]
    wants = [JI.interpolate(xb, size=(oh, ow), mode="bilinear"),
             j_up2x(xb, interpret=True), j_up2x_bl(xb, interpret=True)]
    for fn in (upsample2x_fused, upsample2x_bilinear):
        got = fn(xt)
        assert got.dtype == torch.bfloat16
        got = _f32(got)
        for want in wants:
            np.testing.assert_allclose(got, _f32(want), rtol=0,
                                       atol=_bf16_bound(x, got))


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
