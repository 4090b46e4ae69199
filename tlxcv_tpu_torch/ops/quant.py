"""Post-training int8 quantization for serving (counterpart of the serving
half of ``tlxcv_tpu/ops/quant.py``).

- :func:`quantize_weights`: every Conv2d/Linear weight becomes int8 codes
  with a per-output-channel symmetric scale; activations stay float and
  the weight is dequantized on the fly.
- :func:`calibrate_activations`: records each quantized layer's input
  abs-max over sample batches and attaches ``a_scale``; the layers then
  run int8 x int8 -> int32 (``ops.cuda.matmul``, the hand-written kernel
  on the card).
- :func:`fold_batchnorm` and :func:`fuse_requantize`: serving graph
  rewrites, each verified numerically on the example inputs and rolled
  back when the check fails.
- :func:`quantize_for_serving`: the four in order.
- :func:`enable_qat`, :func:`disable_qat` and :func:`qat_serving_convert`:
  quantization-aware training (the layers' fake quant is in
  ``nn/layers.py``) and its conversion to the int8 serving path, bitwise
  on the weights the fine-tune saw in f32.

Scale formulas are the reference's, in f32.  The verification forwards run
with TF32 off (the reference verifies at ``"highest"`` matmul precision):
cuDNN convolutions would otherwise round f32 operands to TF32, and that
noise, compounded over a 53-conv net, trips the tolerances.  Run the
pipeline on the CPU in f32, as the reference's ``bench.py`` does, then
move the model to the card.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .. import nn
from ..device import full_f32
from ..nn import layers as L

__all__ = ["quantize_weights", "calibrate_activations", "dequantize_check",
           "fold_batchnorm", "fuse_requantize", "quantize_for_serving",
           "enable_qat", "disable_qat", "qat_serving_convert"]


def _quantizable(mod) -> bool:
    return isinstance(mod, (nn.Conv2d, nn.Linear)) and \
        mod.weight.dtype in (torch.float32, torch.bfloat16)


def _int8_layer(mod) -> bool:
    return isinstance(mod, (nn.Conv2d, nn.Linear)) and \
        mod.weight.dtype == torch.int8


def _int8_conv(mod) -> bool:
    return isinstance(mod, nn.Conv2d) and mod.weight.dtype == torch.int8


def _runner(model, forward):
    """A callable taking host arrays or tensors: each goes to the model's
    device in its own dtype (numpy f32 stays f32).  It puts the model in
    eval mode: these are serving forwards, with BatchNorm on its running
    statistics, as the reference runs them."""
    call = forward if forward is not None else model
    device = next(model.parameters()).device
    model.eval()

    def run(x):
        with torch.no_grad():
            return call(torch.as_tensor(x, device=device))
    return run


def _max_abs(t) -> float:
    return float(t.float().abs().max())


@torch.no_grad()
def quantize_weights(model, include: tp.Optional[tp.Callable] = None):
    """In place: convert Conv2d/Linear weights to int8 codes + a per-out
    channel scale, ``max|w| / 127`` (at least 1e-12; a true division on
    either device), codes rounded half to even and clipped to [-127,
    127].  ``include(path, mod) -> bool``
    filters layers (``path`` is torch's dotted module name; default all).
    Returns the number of layers quantized."""
    count = 0
    for path, mod in model.named_modules():
        if not _quantizable(mod):
            continue
        if include is not None and not include(path, mod):
            continue
        w = mod.weight.detach().float()
        bcast = (-1,) + (1,) * (w.ndim - 1)  # OIHW / (out, in): out first
        s = L.true_div(w.abs().amax(dim=tuple(range(1, w.ndim))), 127.0)
        s = torch.clamp_min(s, 1e-12)
        q = torch.round(w / s.reshape(bcast)).clamp(-127, 127).to(torch.int8)
        mod.load_int8(q, s)
        count += 1
    return count


def calibrate_activations(model, batches, percentile: float = 100.0,
                          forward=None):
    """Calibration pass: run the model on host batches, record each int8
    layer's input abs-max, and attach ``a_scale`` (the ``percentile`` of
    the per-batch maxima, / 127) so that later calls take the full-int8
    path.  The pass itself runs every layer weight-only.  Call AFTER
    :func:`quantize_weights`.  ``forward`` overrides the calibration
    callable.  Float layers flagged by :func:`enable_qat` are calibrated
    too: their ``a_scale`` feeds the activation fake quant in training and
    carries over as it is to serving (:func:`qat_serving_convert`); their
    pass runs the weight fake quant alone.  Returns the number of layers
    calibrated."""
    layers = [mod for mod in model.modules()
              if _int8_layer(mod) or getattr(mod, "_qat", False)]
    records = {id(mod): [] for mod in layers}
    stashed = {}
    for mod in layers:  # the calibration forward runs weight-only
        a = getattr(mod, "a_scale", None)
        if a is not None:
            stashed[id(mod)] = a
            del mod.a_scale

    def record(mod, args):
        records[id(mod)].append(_max_abs(args[0]))

    handles = [mod.register_forward_pre_hook(record) for mod in layers]
    try:
        run = _runner(model, forward)
        for x in batches:
            run(x)
    finally:
        for h in handles:
            h.remove()
        for mod in layers:
            if id(mod) in stashed:
                L.set_quant_attr(mod, "a_scale", stashed[id(mod)])

    for mod in layers:
        vals = records[id(mod)]
        if not vals:
            continue
        amax = float(np.percentile(vals, percentile))
        L.set_quant_attr(mod, "a_scale",
                         np.float32(max(amax, 1e-12) / 127.0))
    return len(layers)


def enable_qat(model, act: bool = True,
               include: tp.Optional[tp.Callable] = None) -> int:
    """Turn on quantization-aware training in place: every float Conv2d
    and Linear fake-quantizes its weight on the forward (per output
    channel, straight-through), with :func:`quantize_weights`'s scale and
    clip, so that the loss sees the weights the int8 serving path will
    load.  ``act=True`` also fake-quantizes each layer's input with its
    static scale once :func:`calibrate_activations` has attached
    ``a_scale``::

        enable_qat(model)                    # flags, weight fake quant
        calibrate_activations(model, cal)    # a_scale, QAT layers too
        ... fine-tune (train.Trainer) ...
        qat_serving_convert(model)           # int8 serving

    ``include(path, mod) -> bool`` filters layers (default all); int8
    layers are serving artefacts and are skipped.  Returns the number of
    layers flagged."""
    count = 0
    for path, mod in model.named_modules():
        if not _quantizable(mod):
            continue
        if include is not None and not include(path, mod):
            continue
        mod._qat = True
        mod._qat_act = act
        count += 1
    return count


def disable_qat(model, keep_scales: bool = True) -> int:
    """Clear the QAT flags in place; the calibrated ``a_scale`` stays
    unless ``keep_scales`` is False.  Returns the number of layers that
    were flagged."""
    count = 0
    for mod in model.modules():
        if getattr(mod, "_qat", False):
            count += 1
        for attr in ("_qat", "_qat_act"):
            if hasattr(mod, attr):
                delattr(mod, attr)
        if not keep_scales and getattr(mod, "a_scale", None) is not None:
            del mod.a_scale
    return count


def qat_serving_convert(model,
                        include: tp.Optional[tp.Callable] = None) -> int:
    """Convert a QAT fine-tuned model in place to the int8 serving path:
    each layer's weight quantizes with the scale formula its fake quant
    used, so the served codes are the ones training saw in f32, and the
    calibrated ``a_scale`` carries over as it is (measuring it again would
    break what the fine-tune fitted).  By default only the QAT-flagged
    layers convert, so a layer ``enable_qat(include=...)`` left float stays
    float; ``include`` overrides that, and a model with no flag converts
    every float layer.  The Trainer writes its trained parameters into the
    network at the end of ``train()``; convert after that.  Returns the
    number of layers quantized."""
    if include is None:
        flagged = {id(m) for m in model.modules()
                   if getattr(m, "_qat", False)}
        if flagged:
            include = lambda path, mod: id(mod) in flagged  # noqa: E731
    disable_qat(model, keep_scales=True)
    return quantize_weights(model, include=include)


_TRACED = (nn.Conv2d, nn.Linear, nn.BatchNorm, nn.MaxPool2d)


def _trace(model, example, forward=None):
    """One forward recording an ordered op-event list.

    Each event is ``{"kind", "mod", "in", "out", "ref"}`` where ``in``/
    ``out`` are tensor ``id()``s.  Every traced input and output tensor is
    pinned in ``ref`` so that CPython cannot recycle its id mid-trace (a
    recycled id would fabricate adjacency).  Raw torch ops (``+``,
    slicing, ...) are invisible to the trace by design: callers treat an
    unmatched id as an unknown consumer, and :func:`fold_batchnorm` /
    :func:`fuse_requantize` also verify numerics on the example input.
    """
    events = []

    def hook(mod, args, out):
        ins = tuple(t for t in args if torch.is_tensor(t))
        kind = next(c.__name__ for c in _TRACED if isinstance(mod, c))
        events.append({"kind": kind, "mod": mod,
                       "in": tuple(id(t) for t in ins), "out": id(out),
                       "ref": (ins, out)})

    orig_relu = L.relu

    def traced_relu(t):
        out = orig_relu(t)
        events.append({"kind": "relu", "mod": None, "in": (id(t),),
                       "out": id(out), "ref": (t, out)})
        return out

    handles = [mod.register_forward_hook(hook) for mod in model.modules()
               if isinstance(mod, _TRACED)]
    nn.relu = L.relu = traced_relu
    try:
        _runner(model, forward)(example)
    finally:
        for h in handles:
            h.remove()
        nn.relu = L.relu = orig_relu
    return events


@torch.no_grad()
def fold_batchnorm(model, example, forward=None, tol=1e-2):
    """Fold every eval-mode BatchNorm into its producing Conv2d.

    The BN affine becomes a per-output-channel weight scale + bias on the
    conv: float weights are rescaled in place, an int8 conv folds the
    scale into ``w_scale`` (exact).  Folding uses the RUNNING statistics:
    the folded model is a serving artifact, and a folded BN in training
    mode raises.

    Verifies that the model output on ``example`` moved at most ``tol``
    relative to max|y| (an untraced consumer of a folded tensor breaks the
    equivalence and trips it); on failure every fold is undone and
    ``ValueError`` raised.  Returns the number folded."""
    run = _runner(model, forward)
    with full_f32():
        y0 = run(example).float()
    events = _trace(model, example, forward)
    produced = {}
    consumers = {}
    for ev in events:
        produced[ev["out"]] = ev
        for i in ev["in"]:
            consumers[i] = consumers.get(i, 0) + 1

    count = 0
    undo = []  # restore closures: a failed verification leaves no
    # half-folded model behind
    for ev in events:
        if ev["kind"] != "BatchNorm" or getattr(ev["mod"], "_folded", False):
            continue
        bn = ev["mod"]
        src = produced.get(ev["in"][0])
        if src is None or src["kind"] != "Conv2d":
            continue
        if consumers.get(ev["in"][0], 0) != 1:
            continue  # the conv output has other (traced) consumers
        conv = src["mod"]
        if conv.weight.shape[0] != bn.running_mean.shape[0]:
            continue  # BN not over the conv's output channels
        scale = 1.0 / torch.sqrt(bn.running_var.float() + bn.eps)
        shift = -bn.running_mean.float() * scale
        if bn.weight is not None:
            g = bn.weight.float()
            scale = scale * g
            shift = shift * g
        if bn.bias is not None:
            shift = shift + bn.bias.float()
        old_bias = conv.bias
        if _int8_conv(conv):
            old_ws = conv.w_scale

            def _restore(c=conv, ws=old_ws, ob=old_bias, b_=bn):
                L.set_quant_attr(c, "w_scale", ws)
                c.bias = ob
                b_._folded = False
            L.set_quant_attr(conv, "w_scale", conv.w_scale * scale)
        else:
            old_w = conv.weight.detach().clone()

            def _restore(c=conv, w_=old_w, ob=old_bias, b_=bn):
                c.weight.copy_(w_)
                c.bias = ob
                b_._folded = False
            w = conv.weight
            w.copy_((w.float() * scale[:, None, None, None]).to(w.dtype))
        undo.append(_restore)
        b = shift if conv.bias is None else conv.bias.float() * scale + shift
        L.set_quant_attr(conv, "bias", b)
        bn._folded = True
        count += 1

    with full_f32():
        y1 = run(example).float()
    err = float((y1 - y0).abs().max())
    ref = float(y0.abs().max()) + 1e-12
    if err > tol * ref:
        for f in reversed(undo):
            f()
        raise ValueError(
            f"fold_batchnorm changed the model output (max abs diff {err:g}"
            f" vs max |y| {ref:g}): an untraced consumer reads a folded"
            " conv/BN tensor (model restored; fold selectively or fix the"
            " trace)")
    return count


@torch.no_grad()
def fuse_requantize(model, example, forward=None, tol=0.05):
    """Producer-side int8 requantization for calibrated graphs.

    After :func:`quantize_weights` + :func:`fold_batchnorm` +
    :func:`calibrate_activations`, every int8 conv whose traced consumer
    chain passes only through folded BatchNorms / ReLU / MaxPool2d and
    ends at exactly one calibrated int8 conv gets ``out_scale`` (the
    consumer's input scale) and emits int8 codes directly, the ReLU folded
    in (``relu_fused``) where the chain had one.  The consumer takes the
    codes as they are.

    Raw torch ops (the residual ``+``) are invisible to the trace, so a
    chain that looks linear can hide a second consumer.  Safety is
    therefore numerical: fuse every candidate edge, verify that the output
    moved at most ``tol`` relative on every example (``example`` may be a
    list), and on failure re-add edges one at a time, keeping those that
    hold (greedy rollback).  Returns the number of fused edges kept."""
    examples = list(example) if isinstance(example, (list, tuple)) \
        else [example]
    run = _runner(model, forward)

    def output(x):
        with full_f32():
            return run(x).float()

    y0s = [output(x) for x in examples]
    events = _trace(model, examples[0], forward)
    consumers = {}
    for ev in events:
        if ev["out"] in ev["in"]:
            continue  # identity pass-through (a folded BN returns its
            # input object): transparent, not a real consumer
        for i in ev["in"]:
            consumers.setdefault(i, []).append(ev)

    edges = []  # (producer module, relu_seen, consumer a_scale)
    for ev in events:
        if ev["kind"] != "Conv2d" or not _int8_conv(ev["mod"]) or \
                getattr(ev["mod"], "a_scale", None) is None or \
                getattr(ev["mod"], "out_scale", None) is not None:
            continue
        cur, relu_seen = ev["out"], False
        target = None
        for _ in range(8):  # bounded chain walk
            nxt = consumers.get(cur, [])
            if len(nxt) != 1:
                break
            c = nxt[0]
            if c["kind"] == "relu":
                relu_seen, cur = True, c["out"]
            elif c["kind"] == "BatchNorm" and getattr(c["mod"], "_folded",
                                                      False):
                cur = c["out"]
            elif c["kind"] == "MaxPool2d":
                cur = c["out"]
            elif c["kind"] == "Conv2d" and _int8_conv(c["mod"]) and \
                    getattr(c["mod"], "a_scale", None) is not None:
                target = c["mod"]
                break
            else:
                break
        if target is not None:
            edges.append((ev["mod"], relu_seen, target.a_scale.clone()))

    refs = [float(y0.abs().max()) + 1e-12 for y0 in y0s]

    def fuse(mod, relu_seen, scale):
        L.set_quant_attr(mod, "out_scale", scale)
        mod.relu_fused = relu_seen

    def unfuse(mod):
        del mod.out_scale
        if hasattr(mod, "relu_fused"):
            del mod.relu_fused

    def ok():
        for x, y0, ref in zip(examples, y0s, refs):
            if float((output(x) - y0).abs().max()) > tol * ref:
                return False
        return True

    for mod, relu_seen, scale in edges:
        fuse(mod, relu_seen, scale)
    if edges and not ok():
        # some edge's tensor has an untraced second consumer: greedy
        # re-add with per-edge verification
        for mod, _, _ in edges:
            unfuse(mod)
        kept = []
        for mod, relu_seen, scale in edges:
            fuse(mod, relu_seen, scale)
            if ok():
                kept.append(mod)
            else:
                unfuse(mod)
        edges = [e for e in edges if e[0] in kept]
        if edges and not ok():  # the combined effect must also hold
            for mod, _, _ in edges:
                unfuse(mod)
            raise ValueError(
                "fuse_requantize: per-edge-verified set fails combined "
                "verification (rounding interactions exceed tol); raise "
                "tol or fuse manually")
    return len(edges)


def quantize_for_serving(model, calib_batches, forward=None,
                         percentile: float = 100.0):
    """One-call full-int8 serving pipeline: fold BN -> int8 weights ->
    activation calibration -> producer-side requantize fusion.

    ``calib_batches``: iterable of host input arrays (the first is the
    fold verification example; the fusion verifies against all).  Returns
    ``(n_folded, n_quantized, n_calibrated, n_fused)``."""
    batches = list(calib_batches)
    n_fold = fold_batchnorm(model, batches[0], forward)
    n_q = quantize_weights(model)
    n_cal = calibrate_activations(model, batches, percentile, forward)
    n_fuse = fuse_requantize(model, batches, forward)
    return n_fold, n_q, n_cal, n_fuse


def dequantize_check(model) -> dict:
    """Per-layer half-step bound of the weight error, max|w_scale| / 2
    (sanity harness)."""
    return {path: float(mod.w_scale.abs().max()) * 0.5
            for path, mod in model.named_modules() if _int8_layer(mod)}
