"""The StarCoder2 decoder (arXiv:2402.19173) in plain float32 PyTorch.

Each layer: LayerNorm, grouped-query attention with biases on q, k, v and
o, RoPE on q and k (after their biases), causal; LayerNorm, an MLP of
``intermediate_size`` with biases and the tanh GELU; residuals around
both.  A final LayerNorm; the head is the embedding (tied).  The numbers
come from the configuration file (``hidden_size`` ... ``norm_epsilon``,
``rope_theta``) as the benchmark runs it.

Parameters are the flat dict of :meth:`Model.param_table`: every layer's
weights stacked on a leading axis, named as the benchmark hands them to the
program under test and to this reference alike.
"""
from __future__ import annotations

import math

from .common import Layer, Leaf, causal_attention, fan_in_leaf, gelu_tanh, layer_norm, rope

EMBED_STD = 0.02  # the embedding (and tied head): logits of unit-norm states ~ N(0, 1.1)


class Model:
    aux_weight = 0.0

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = self.d // self.h
        self.f = cfg["intermediate_size"]
        self.v = cfg["vocab_size"]
        self.n_layers = cfg["num_hidden_layers"]
        self.eps = cfg["norm_epsilon"]
        self.theta = cfg["rope_theta"]
        self.layers = [Layer("blocks.", i, self._block) for i in range(self.n_layers)]
        self.head_params = ["embed", "final_norm.bias", "final_norm.scale"]

    # -- parameters -------------------------------------------------------------------------
    def param_table(self) -> dict[str, Leaf]:
        d, h, hkv, hd, f, n = self.d, self.h, self.hkv, self.hd, self.f, self.n_layers
        ones, zeros = (lambda *s: Leaf(s, "ones")), (lambda *s: Leaf(s, "zeros"))
        return {
            "blocks.attn.bk": zeros(n, hkv, hd), "blocks.attn.bo": zeros(n, d),
            "blocks.attn.bq": zeros(n, h, hd), "blocks.attn.bv": zeros(n, hkv, hd),
            "blocks.attn.wk": fan_in_leaf((n, d, hkv, hd), d),
            "blocks.attn.wo": fan_in_leaf((n, h, hd, d), h * hd),
            "blocks.attn.wq": fan_in_leaf((n, d, h, hd), d),
            "blocks.attn.wv": fan_in_leaf((n, d, hkv, hd), d),
            "blocks.ln1.bias": zeros(n, d), "blocks.ln1.scale": ones(n, d),
            "blocks.ln2.bias": zeros(n, d), "blocks.ln2.scale": ones(n, d),
            "blocks.mlp.down": fan_in_leaf((n, f, d), f), "blocks.mlp.down_b": zeros(n, d),
            "blocks.mlp.up": fan_in_leaf((n, d, f), d), "blocks.mlp.up_b": zeros(n, f),
            "embed": Leaf((self.v, d), "normal", EMBED_STD),
            "final_norm.bias": zeros(d), "final_norm.scale": ones(d),
        }

    def active_matmul_params(self) -> int:
        """Weights a token multiplies in one forward pass: every layer's four
        projections and two MLP matrices, and the head (the tied embedding as
        a product; its lookup is no product)."""
        d, h, hkv, hd, f = self.d, self.h, self.hkv, self.hd, self.f
        per_layer = d * h * hd * 2 + d * hkv * hd * 2 + 2 * d * f
        return self.n_layers * per_layer + self.v * d

    def attention(self) -> dict:
        """Each layer's attention: heads, key/value heads, q/k and v widths."""
        return {"layers": self.n_layers, "heads": self.h, "kv_heads": self.hkv,
                "qk_dim": self.hd, "v_dim": self.hd}

    # -- the model ----------------------------------------------------------------------------
    def embed(self, params, tokens):
        return params["embed"][tokens]

    def embed_backward(self, grads, tokens, gh):
        grads["embed"].index_add_(0, tokens.reshape(-1), gh.reshape(-1, self.d))

    def _block(self, p, h, prec):
        x = layer_norm(h, p["ln1.scale"], p["ln1.bias"], self.eps)
        q = prec.einsum("bsd,dhk->bshk", x, p["attn.wq"]) + p["attn.bq"]
        k = prec.einsum("bsd,dhk->bshk", x, p["attn.wk"]) + p["attn.bk"]
        v = prec.einsum("bsd,dhk->bshk", x, p["attn.wv"]) + p["attn.bv"]
        q, k = rope(q, self.theta), rope(k, self.theta)
        o = causal_attention(q, k, v, 1.0 / math.sqrt(self.hd), prec)
        h = h + prec.einsum("bshk,hkd->bsd", o, p["attn.wo"]) + p["attn.bo"]
        x = layer_norm(h, p["ln2.scale"], p["ln2.bias"], self.eps)
        u = gelu_tanh(prec.matmul(x, p["mlp.up"]) + p["mlp.up_b"])
        return h + prec.matmul(u, p["mlp.down"]) + p["mlp.down_b"], None

    def logits(self, head, hc, prec):
        x = layer_norm(hc, head["final_norm.scale"], head["final_norm.bias"], self.eps)
        return prec.matmul(x, head["embed"].t())
