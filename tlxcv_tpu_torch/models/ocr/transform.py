"""OCR tokenizers and preprocessing (counterpart of
``tlxcv_tpu/models/ocr/transform.py``): a pure-Python GPT-2 byte-level
BPE, a character tokenizer, and ``TrOCRTransform``.

``TrOCRTransform`` resizes as ``cv2.resize(..., INTER_LINEAR)`` does,
without OpenCV (``resize_linear``): a uint8 image (what PIL hands
Synth90k) through OpenCV's fixed-point route, bitwise; a float image
through ``F.interpolate``'s bilinear at half-pixel centres.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bytes_to_unicode", "get_pairs", "BPETokenizer", "CharTokenizer",
           "TrOCRTransform", "resize_linear"]


def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


_PRETOKENIZE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+""")


class BPETokenizer:
    """GPT-2 byte-level BPE (encode and decode) on the host, from a
    ``vocab.json`` and a ``merges.txt``."""

    def __init__(self, vocab_file, merges_file, bos_token="<s>",
                 eos_token="</s>", pad_token="<pad>", unk_token="<unk>"):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")[1:]
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: dict[str, str] = {}
        self.bos_token_id = self.encoder.get(bos_token, 0)
        self.eos_token_id = self.encoder.get(eos_token, 2)
        self.pad_token_id = self.encoder.get(pad_token, 1)
        self.unk_token = unk_token

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first and
                        word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text):
        unk = self.encoder.get(self.unk_token, 3)
        ids = []
        for token in _PRETOKENIZE.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(t, unk)
                       for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids):
        specials = {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        text = "".join(self.decoder.get(int(i), "")
                       for i in ids if int(i) not in specials)
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace")


class CharTokenizer:
    """Character-level tokenizer with the BPE's special ids (BOS 0, PAD 1,
    EOS 2), for Synth90k without a published vocabulary."""

    def __init__(self, alphabet="0123456789abcdefghijklmnopqrstuvwxyz"):
        self.bos_token_id, self.pad_token_id, self.eos_token_id = 0, 1, 2
        self.itos = ["<s>", "<pad>", "</s>"] + list(alphabet)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.vocab_size = len(self.itos)

    def encode(self, text):
        return [self.stoi[c] for c in text.lower() if c in self.stoi]

    def decode(self, ids):
        return "".join(self.itos[int(i)] for i in ids
                       if 2 < int(i) < self.vocab_size)


# OpenCV's INTER_LINEAR weights for 8-bit images: 11 fractional bits
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(dst, src, clamp):
    """OpenCV's source index and fixed-point weight pair of each output
    pixel: the centre ``(d + 0.5) * scale - 0.5`` in f32, its floor and
    fraction; ``clamp`` (the columns) moves a centre past either edge onto
    the edge pixel with weights (1, 0), the rows keep it (their reads are
    clamped instead).  Weights are the fractions times 2048, rounded half
    to even."""
    scale = 1.0 / (dst / src)
    centre = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    index = np.floor(centre).astype(np.int64)
    frac = (centre - index.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (index < 0) | (index >= src - 1)
        frac[edge] = 0.0
        index = np.clip(index, 0, src - 1)
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(_COEF_SCALE)
                 ).astype(np.int64)
    return index, w0, w1


def _resize_linear_u8(image, out_hw):
    """``cv2.resize(image, (w, h))`` of a uint8 HWC or HW image, bitwise:
    the horizontal pass sums integer pixels times 11-bit weights exactly;
    the vertical pass is OpenCV's vector arithmetic, used on every row
    whatever its width: each sum shifted right by 4, multiplied by its
    weight keeping the high 16 bits, the two added, then rounded off by 2
    more bits and saturated."""
    oh, ow = out_hw
    img = image.astype(np.int64)
    h, w = img.shape[:2]
    sx, ax0, ax1 = _linear_taps(ow, w, clamp=True)
    sy, ay0, ay1 = _linear_taps(oh, h, clamp=False)
    expand = (slice(None), None) if img.ndim == 3 else (slice(None),)
    rows = (img[:, sx] * ax0[expand]
            + img[:, np.minimum(sx + 1, w - 1)] * ax1[expand])
    s0 = rows[np.clip(sy, 0, h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    b0 = ay0.reshape((-1,) + (1,) * (img.ndim - 1))
    b1 = ay1.reshape((-1,) + (1,) * (img.ndim - 1))
    out = (((s0 * b0) >> 16) + ((s1 * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear(image, out_hw):
    """An HW or HWC image resized to ``out_hw`` (rows, columns) as
    ``cv2.resize(image, out_hw[::-1])`` with INTER_LINEAR: uint8 bitwise
    (``_resize_linear_u8``); any other dtype as float32, bilinear at
    half-pixel centres with the edges clamped.  One channel comes back HW,
    as OpenCV returns it."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.dtype == np.uint8:
        return _resize_linear_u8(image, out_hw)
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    chw = x[None] if x.ndim == 2 else x.permute(2, 0, 1)
    y = F.interpolate(chw[None], size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    return (y[0] if x.ndim == 2 else y.permute(1, 2, 0)).numpy()


class TrOCRTransform:
    """Image and text preprocessing for TrOCR: the image resized to
    ``size``, grey made RGB, scaled to [0, 1] and normalised; the text
    encoded, cut to ``max_length - 1``, EOS appended, padded."""

    def __init__(self, tokenizer, size=(384, 384), max_length=128,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.tokenizer = tokenizer
        self.size = size
        self.max_length = max_length
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, text=None):
        img = resize_linear(image, self.size)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = (img.astype(np.float32) / 255.0 - self.mean) / self.std
        if text is None:
            return img
        ids = self.tokenizer.encode(text)[: self.max_length - 1]
        ids = ids + [self.tokenizer.eos_token_id]
        ids += [self.tokenizer.pad_token_id] * (self.max_length - len(ids))
        return img, np.asarray(ids, np.int32)
