"""TrOCR (counterpart of ``tlxcv_tpu/models/ocr/trocr.py``): a ViT encoder
and a causal transformer decoder with learned positions, trained by
teacher forcing, decoding greedily or by beam search with a KV cache.

Every attention goes through ``nn.attention.scaled_dot_product_attention``
(the flash kernel on the card).  Its masks are batch- and head-invariant,
so each reaches the kernel as one ``[1, Sq, Sk]`` bias: the causal one of
teacher forcing, and a decode step's ``[1, 1, T]`` mask of the cache's
filled slots.

Decoding is a Python loop under ``torch.inference_mode()`` where the
reference runs one ``lax.scan``: every one of ``max_length`` steps runs,
finished rows emitting PAD, and each step writes its k and v into a
preallocated ``[B, H, T, d]`` cache by an indexed copy; the encoder
memory's cross-attention K and V are computed once, before the loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device
from ...nn.attention import scaled_dot_product_attention

__all__ = ["TrOCR", "ViTEncoder", "TrOCRDecoder"]

NEG = -1e9


class ViTEncoder(tnn.Module):
    """Image encoder: class token and patches, pre-LN blocks."""

    def __init__(self, img_size=384, patch_size=16, embed_dim=384, depth=6,
                 num_heads=6, mlp_ratio=4.0, device=None, generator=None):
        super().__init__()
        from ..classification.vision_transformer import Block, PatchEmbed

        kw = dict(device=device, generator=generator)
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim, **kw)
        n = self.patch_embed.num_patches
        self.cls_token = tnn.Parameter(
            I.truncated_normal((1, 1, embed_dim), std=0.02, **kw))
        self.pos_embed = tnn.Parameter(
            I.truncated_normal((1, n + 1, embed_dim), std=0.02, **kw))
        self.blocks = tnn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=True, **kw)
            for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, device=device)
        self.embed_dim = embed_dim

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class _Heads(tnn.Module):
    """q, k, v and output projections of ``dim`` over ``num_heads``."""

    def __init__(self, dim, num_heads, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    def _split(self, x):
        b, n, _ = x.shape
        return x.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge(self, o):
        b, h, n, d = o.shape
        return self.out(o.transpose(1, 2).reshape(b, n, h * d))


class CrossAttention(_Heads):
    def kv(self, memory):
        """The memory's K and V projections, [B, H, M, d] each: loop
        invariants, computed once before a decode loop."""
        return self._split(self.k(memory)), self._split(self.v(memory))

    def with_kv(self, x, kk, vv, mask=None):
        return self._merge(scaled_dot_product_attention(
            self._split(self.q(x)), kk, vv, mask=mask))

    def forward(self, x, memory, mask=None):
        return self.with_kv(x, *self.kv(memory), mask=mask)


def causal_mask(n, dtype, device):
    """[n, n] additive mask: ``NEG`` above the diagonal, 0 elsewhere."""
    return torch.triu(torch.full((n, n), NEG, dtype=dtype, device=device), 1)


def cache_masks(length, device):
    """Every decode step's mask, [length, 1, 1, 1, length] f32: step
    ``pos``'s row is 0 on the cache's slots up to ``pos`` and ``NEG`` on
    the empty ones after it.  Made once a decode; a step takes its row."""
    slots = torch.arange(length, device=device)
    return torch.where(slots[None] <= slots[:, None], 0.0, NEG).view(
        length, 1, 1, 1, length)


class SelfAttentionKV(_Heads):
    """Causal self-attention, over a whole sequence (``full``) or one step
    against a KV cache (``step``)."""

    def full(self, x):
        causal = causal_mask(x.shape[1], x.dtype, x.device)
        return self._merge(scaled_dot_product_attention(
            self._split(self.q(x)), self._split(self.k(x)),
            self._split(self.v(x)), mask=causal))

    def step(self, x_t, cache_k, cache_v, pos, mask):
        """x_t [B, 1, D]; cache [B, H, T, d], written in place at slot
        ``pos`` (an int); ``mask`` the step's row of ``cache_masks``."""
        cache_k[:, :, pos:pos + 1] = self._split(self.k(x_t))
        cache_v[:, :, pos:pos + 1] = self._split(self.v(x_t))
        o = scaled_dot_product_attention(self._split(self.q(x_t)), cache_k,
                                         cache_v, mask=mask)
        return self._merge(o), cache_k, cache_v


class DecoderLayer(tnn.Module):
    def __init__(self, dim, num_heads, ffn_dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = SelfAttentionKV(dim, num_heads, **kw)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.cross_attn = CrossAttention(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, ffn_dim, **kw)
        self.fc2 = nn.Linear(ffn_dim, dim, **kw)
        self.norm3 = nn.LayerNorm(dim, device=device)

    def _ffn(self, x):
        return self.norm3(x + self.fc2(nn.get_activation("gelu")(
            self.fc1(x))))

    def full(self, x, memory):
        x = self.norm1(x + self.self_attn.full(x))
        x = self.norm2(x + self.cross_attn(x, memory))
        return self._ffn(x)

    def step(self, x_t, mem_kv, ck, cv, pos, mask):
        y, ck, cv = self.self_attn.step(x_t, ck, cv, pos, mask)
        x_t = self.norm1(x_t + y)
        x_t = self.norm2(x_t + self.cross_attn.with_kv(x_t, *mem_kv))
        return self._ffn(x_t), ck, cv


class TrOCRDecoder(tnn.Module):
    """Causal LM decoder with learned positions (offset by 2, as BART)."""

    def __init__(self, vocab_size=64044, dim=256, depth=6, num_heads=8,
                 ffn_dim=1024, max_positions=128, pad_token_id=1,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embed_tokens = nn.Embedding(vocab_size, dim, **kw)
        self.embed_positions = nn.Embedding(max_positions + 2, dim, **kw)
        self.embed_scale = math.sqrt(dim)
        self.layernorm_embedding = nn.LayerNorm(dim, device=device)
        self.layers = tnn.ModuleList([
            DecoderLayer(dim, num_heads, ffn_dim, **kw) for _ in range(depth)])
        self.output_projection = nn.Linear(dim, vocab_size, bias=False, **kw)
        self.dim = dim
        self.num_heads = num_heads
        self.max_positions = max_positions
        self.vocab_size = vocab_size

    def _embed(self, ids, positions):
        x = self.embed_tokens(ids) * self.embed_scale
        x = x + self.embed_positions(positions + 2)
        return self.layernorm_embedding(x)

    def forward(self, input_ids, memory):
        n = input_ids.shape[1]
        if n > self.max_positions:
            raise ValueError(
                f"sequence length {n} exceeds max_positions "
                f"{self.max_positions} (the position table would be "
                f"silently clipped)")
        x = self._embed(input_ids, torch.arange(n, device=input_ids.device)
                        [None])
        for layer in self.layers:
            x = layer.full(x, memory)
        return self.output_projection(x)

    def init_cache(self, batch, max_len, dtype=torch.float32, device=None):
        shape = (batch, self.num_heads, max_len, self.dim // self.num_heads)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in self.layers]

    def memory_kv(self, memory):
        """Each layer's cross-attention K and V of the encoder memory:
        compute once before a decode loop."""
        return [layer.cross_attn.kv(memory) for layer in self.layers]

    def decode_step(self, token, pos, memory, cache, mem_kvs=None,
                    mask=None):
        """One token [B] at position ``pos`` (an int) through every layer;
        returns the logits [B, vocab] and the cache, written in place.
        ``mask``: the step's row of ``cache_masks`` (made here if None)."""
        positions = torch.full((1, 1), pos, dtype=torch.long,
                               device=token.device)
        x = self._embed(token[:, None], positions)
        if mem_kvs is None:
            mem_kvs = self.memory_kv(memory)
        if mask is None:
            mask = cache_masks(cache[0][0].shape[2], token.device)[pos]
        new_cache = []
        for layer, (ck, cv), kv in zip(self.layers, cache, mem_kvs):
            x, ck, cv = layer.step(x, kv, ck, cv, pos, mask)
            new_cache.append((ck, cv))
        return self.output_projection(x)[:, 0], new_cache


def _top_k(x, k):
    """The ``k`` largest of each row with their indices, ties in index
    order, as ``jax.lax.top_k`` (``torch.topk`` promises no order among
    ties): a stable descending sort."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


class TrOCR(tnn.Module):
    """``device=None`` builds on the CUDA card."""

    def __init__(self, vocab_size=64044, encoder_dim=384, encoder_depth=6,
                 encoder_heads=6, decoder_dim=256, decoder_depth=6,
                 decoder_heads=8, img_size=384, patch_size=16,
                 max_length=128, bos_token_id=0, pad_token_id=1,
                 eos_token_id=2, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.encoder = ViTEncoder(img_size, patch_size, encoder_dim,
                                  encoder_depth, encoder_heads, **kw)
        self.enc_to_dec = (nn.Linear(encoder_dim, decoder_dim, **kw)
                           if encoder_dim != decoder_dim else nn.Identity())
        self.decoder = TrOCRDecoder(vocab_size, decoder_dim, decoder_depth,
                                    decoder_heads, decoder_dim * 4,
                                    max_length, **kw)
        self.max_length = max_length
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id

    def encode(self, images):
        return self.enc_to_dec(self.encoder(images))

    def forward(self, images, input_ids=None):
        memory = self.encode(images)
        if input_ids is None:
            return self.generate(images, memory=memory)
        return self.decoder(input_ids, memory)

    def loss_fn(self, images, labels):
        """Teacher forcing: inputs [BOS, y...], targets [y..., EOS], PAD
        masked out of the mean."""
        memory = self.encode(images)
        labels = labels.long()
        bos = torch.full((labels.shape[0], 1), self.bos_token_id,
                         dtype=labels.dtype, device=labels.device)
        logits = self.decoder(torch.cat([bos, labels[:, :-1]], 1), memory)
        mask = (labels != self.pad_token_id).float()
        logp = F.log_softmax(logits, -1)
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)

    def generate(self, images=None, memory=None):
        """Greedy decode, [B, max_length] int32 tokens."""
        with torch.inference_mode():
            if memory is None:
                memory = self.encode(images)
            b, dev = memory.shape[0], memory.device
            cache = self.decoder.init_cache(b, self.max_length, memory.dtype,
                                            dev)
            mem_kvs = self.decoder.memory_kv(memory)
            masks = cache_masks(self.max_length, dev)
            token = torch.full((b,), self.bos_token_id, dtype=torch.long,
                               device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            tokens = []
            for pos in range(self.max_length):
                logits, cache = self.decoder.decode_step(
                    token, pos, memory, cache, mem_kvs, masks[pos])
                token = torch.where(done, self.pad_token_id,
                                    logits.argmax(-1))
                done = done | (token == self.eos_token_id)
                tokens.append(token)
            return torch.stack(tokens, 1).to(torch.int32)

    def generate_beam(self, images=None, memory=None, num_beams=4,
                      length_penalty=1.0):
        """Beam search with a KV cache per beam, reordered by a gather at
        every step.  Returns [B, max_length] int32 tokens of the best beam
        by summed log-probability over length ** ``length_penalty``.  The
        bookkeeping stays f32."""
        with torch.inference_mode():
            if memory is None:
                memory = self.encode(images)
            b, k, dev = memory.shape[0], num_beams, memory.device
            t = self.max_length
            mem = memory.repeat_interleave(k, 0)           # [B*K, M, D]
            mem_kvs = self.decoder.memory_kv(mem)
            cache = self.decoder.init_cache(b * k, t, memory.dtype, dev)
            masks = cache_masks(self.max_length, dev)
            vocab = self.decoder.output_projection.weight.shape[0]
            # only beam 0 is live at the start: every beam holds BOS
            scores = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
            scores[:, 0] = 0.0
            pad_only = torch.full((vocab,), NEG, dtype=torch.float32,
                                  device=dev)
            pad_only[self.pad_token_id] = 0.0
            last = torch.full((b, k), self.bos_token_id, dtype=torch.long,
                              device=dev)
            buf = torch.full((b, k, t), self.pad_token_id, dtype=torch.long,
                             device=dev)
            done = torch.zeros((b, k), dtype=torch.bool, device=dev)
            lengths = torch.zeros((b, k), dtype=torch.float32, device=dev)
            rows = torch.arange(b, device=dev)[:, None] * k
            for pos in range(t):
                logits, cache = self.decoder.decode_step(
                    last.reshape(b * k), pos, mem, cache, mem_kvs, masks[pos])
                logp = F.log_softmax(logits.float(), -1).reshape(b, k, vocab)
                # finished beams may only emit PAD, at no cost
                logp = torch.where(done[..., None], pad_only, logp)
                cand = (scores[..., None] + logp).reshape(b, k * vocab)
                scores, idx = _top_k(cand, k)
                beam = idx // vocab
                last = idx % vocab
                buf = buf.gather(1, beam[..., None].expand(b, k, t))
                done_prev = done.gather(1, beam)
                lengths = lengths.gather(1, beam) + (~done_prev).float()
                done = done_prev | (last == self.eos_token_id)
                buf[:, :, pos] = last
                flat = (rows + beam).reshape(-1)
                cache = [(ck[flat], cv[flat]) for ck, cv in cache]
            final = scores / lengths.clamp_min(1.0) ** length_penalty
            best = final.argmax(1)
            return buf[torch.arange(b, device=dev), best].to(torch.int32)
