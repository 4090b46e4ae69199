"""Hold a hermetic accuracy check's training loop in the port against the
reference's on the CPU, from the same initial weights: the tool that
tells a port fault from initial-weight variance when a check misses its
floor on the card.

    JAX_PLATFORMS=cpu python -m tests.accuracy_parity ocr --save-init FILE
        # the reference's initial TrOCR (its script's first build: the
        # JAX package's init RNG at its seed 0), as an .npz the port's
        # check takes with --init=FILE
    JAX_PLATFORMS=cpu python -m tests.accuracy_parity ocr|detr_r50
        [--steps 300] [--log-every 25] [--out FILE]
        # both loops for --steps steps at the check's own schedule (OCR's
        # 6,000-step horizon; DETR-R50's second stage, 12,000) on the same
        # batches; prints one JSON line: the two losses at every log point
        # and their relative gap

Not a test (it takes minutes): run it by hand.
"""
import argparse
import json
import sys
import time

import numpy as np


def _reference_trocr():
    from demo.ocr import accuracy_check as RO
    from tlxcv_tpu.models.ocr import CharTokenizer, TrOCR

    tok = CharTokenizer()
    return tok, TrOCR(vocab_size=tok.vocab_size, encoder_dim=128,
                      encoder_depth=3, encoder_heads=4, decoder_dim=128,
                      decoder_depth=2, decoder_heads=4, img_size=(RO.H, RO.W),
                      patch_size=8, max_length=RO.LEN + 3)


def _flat(module):
    from tlxcv_tpu.core import split

    params, state = split(module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def ocr_save_init(path):
    _, jm = _reference_trocr()
    np.savez(path, **_flat(jm))


def ocr_compare(steps, log_every, horizon=6000):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from demo.ocr import accuracy_check as RO
    from tlxcv_tpu.core import pure, split
    from tlxcv_tpu_torch.demo.ocr import accuracy_check as PO
    from tlxcv_tpu_torch.models.ocr import CharTokenizer
    from tlxcv_tpu_torch.utils import load_jax_params

    jtok, jm = _reference_trocr()
    tm = PO.build(CharTokenizer(), "cpu")
    load_jax_params(tm, _flat(jm))
    tm.train()
    params, state = split(jm)
    lp = pure(jm, lambda m, x, y: m.loss_fn(x, y))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 5e-4, 300,
                                                        horizon),
                     weight_decay=1e-4)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, g = jax.value_and_grad(
            lambda p: lp(p, state, x, y, training=True)[0])(params)
        u, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), opt_state, loss

    opt = PO.optimizer(tm, horizon)
    rng = np.random.default_rng(0)
    rows = []
    t0 = time.time()
    for it in range(steps):
        x, y, _ = RO.sample(rng, jtok, 32)
        params, opt_state, jloss = step(params, opt_state, jnp.asarray(x),
                                        jnp.asarray(y))
        tloss = PO.train_step(tm, opt, torch.from_numpy(x),
                              torch.from_numpy(y))
        if it % log_every == 0 or it == steps - 1:
            j, t = float(jloss), float(tloss)
            rows.append({"step": it, "reference": j, "port": t,
                         "rel_gap": abs(t - j) / abs(j)})
            print(f"it {it} reference {j:.5f} port {t:.5f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return {"check": "ocr", "steps": steps, "horizon": horizon,
            "losses": rows, "seconds": round(time.time() - t0, 1)}


def detr_r50_compare(steps, log_every, horizon=12000):
    """The DETR-R50 check's second stage (frozen-BatchNorm ResNet-50, the
    backbone at a tenth of 2e-4, gradients clipped to 0.1, cosine over its
    12,000 steps, b32) from the reference's initial weights; the backbone
    is not pretrained here (the first stage is another loop)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from demo.object_detection import accuracy_sweep as RS
    from tlxcv_tpu.core import pure, split
    from tlxcv_tpu.core.init import set_seed
    from tlxcv_tpu.data import ShapesDetection as JShapes
    from tlxcv_tpu.models.detection import Detr as JDetr
    from tlxcv_tpu_torch.data import ShapesDetection
    from tlxcv_tpu_torch.demo.object_detection import accuracy_sweep as PS
    from tlxcv_tpu_torch.models.detection import Detr
    from tlxcv_tpu_torch.utils import load_jax_params

    cfg = dict(num_classes=3, num_queries=25, enc_layers=4, dec_layers=4,
               dropout=0.0, backbone_depth=50, freeze_bn=True)
    set_seed(0)
    jm = JDetr(**cfg)
    tm = Detr(**cfg, device="cpu")
    load_jax_params(tm, _flat(jm))
    tm.train()
    params, state = split(jm)
    lp = pure(jm, lambda m, v, t: m.loss_fn(m(v), t))
    lr, opts = 2e-4, {"backbone_lr_mult": 0.1, "clip": 0.1}
    labels = {k: ("backbone" if k.startswith("backbone") else "main")
              for k in params}
    tx = optax.chain(optax.clip_by_global_norm(opts["clip"]),
                     optax.multi_transform(
                         {"backbone": optax.adam(optax.cosine_decay_schedule(
                             lr * 0.1, horizon)),
                          "main": optax.adam(optax.cosine_decay_schedule(
                              lr, horizon))}, labels))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, state, opt_state, x, t):
        t = RS._tgt_norm_cxcywh(t)
        (loss, state), g = jax.value_and_grad(
            lambda p: lp(p, state, x, t, training=True), has_aux=True)(params)
        u, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, u), state, opt_state, loss

    opt = PS._optimizer(tm, "detr_r50", lr, horizon, opts)
    jtrain = JShapes(num=4096, size=128, seed=0)
    train = ShapesDetection(num=4096, size=128, seed=0)
    rng = np.random.default_rng(0)
    rows = []
    t0 = time.time()
    for it in range(steps):
        idxs = rng.integers(0, 4096, size=32)
        x, t = RS.batcher(jtrain, idxs)
        params, state, opt_state, jloss = step(params, state, opt_state, x, t)
        px, pt = PS.batcher(train, idxs)
        tloss = PS.train_step(tm, opt, torch.from_numpy(px),
                              PS._tgt_norm_cxcywh(PS.A.to_device(pt, "cpu")))
        if it % log_every == 0 or it == steps - 1:
            j, t_ = float(jloss), float(tloss)
            rows.append({"step": it, "reference": j, "port": t_,
                         "rel_gap": abs(t_ - j) / abs(j)})
            print(f"it {it} reference {j:.5f} port {t_:.5f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return {"check": "detr_r50", "steps": steps, "horizon": horizon,
            "losses": rows, "seconds": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("check", choices=["ocr", "detr_r50"])
    ap.add_argument("--save-init")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    torch.set_num_threads(a.threads)
    if a.save_init:
        ocr_save_init(a.save_init)
        return
    compare = {"ocr": ocr_compare, "detr_r50": detr_r50_compare}[a.check]
    result = compare(a.steps, a.log_every)
    line = json.dumps(result)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
