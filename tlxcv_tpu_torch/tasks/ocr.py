"""OCR task (counterpart of ``tlxcv_tpu/tasks/ocr.py``): the task,
Levenshtein distance, the character error rate and greedy validation."""
from __future__ import annotations

import numpy as np
from torch import nn

__all__ = ["OpticalCharacterRecognition", "edit_distance",
           "character_error_rate", "valid"]


class OpticalCharacterRecognition(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, inputs):
        # in training the forward hands the images on: the loss encodes
        # them and runs the decoder by teacher forcing; in eval it runs
        # the backbone (greedy decoding)
        if self.training:
            return inputs
        return self.backbone(inputs)

    def loss_fn(self, output, target):
        return self.backbone.loss_fn(output, target)

    def predict(self, inputs):
        return self.backbone.generate(inputs)


def edit_distance(a, b):
    """Levenshtein distance (host-side)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def character_error_rate(predictions, references):
    """Edit distances over reference characters, over lists of strings."""
    assert len(predictions) == len(references), \
        (len(predictions), len(references))
    errors = sum(edit_distance(p, r) for p, r in zip(predictions, references))
    total = sum(len(r) for r in references)
    return errors / max(total, 1)


def valid(model_or_trainer, dataset, tokenizer, max_batches=None):
    """Greedy-decode a dataset of (images, label ids) and return the
    CER."""
    preds, refs = [], []
    for bi, (images, labels) in enumerate(dataset):
        if max_batches is not None and bi >= max_batches:
            break
        if hasattr(model_or_trainer, "predict"):
            tokens = model_or_trainer.predict(images)
        else:
            tokens = model_or_trainer.generate(images)
        tokens = np.asarray(tokens.cpu() if hasattr(tokens, "cpu")
                            else tokens)
        for t, l in zip(tokens, np.asarray(labels)):
            preds.append(tokenizer.decode(t))
            refs.append(tokenizer.decode(l))
    return character_error_rate(preds, refs)
