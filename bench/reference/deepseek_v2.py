"""The DeepSeek-V2 decoder (arXiv:2405.04434) in plain float32 PyTorch.

Multi-head Latent Attention, expanded: c_kv = RMSNorm(x W_dkv[:rank]) and a
RoPE key shared by the heads from x W_dkv[rank:]; per head the key [c_kv
W_uk | k_rope] and the value c_kv W_uv; queries x W_q (no query
compression: ``q_lora_rank`` null), split [nope | rope] with RoPE on the
rope part; causal softmax at 1/sqrt(qk_nope + qk_rope); out W_o.

The first ``first_k_dense_replace`` layers end in a SwiGLU MLP of
``intermediate_size``; the others in a mixture of experts: a softmax router
over ``n_routed_experts``, the top ``num_experts_per_tok`` by a stable
descending sort (equal probabilities: the lower expert first), their weights
renormalized to sum 1 (``norm_topk_prob``), each expert a SwiGLU of
``moe_intermediate_size``, plus ``n_shared_experts`` shared experts (one
SwiGLU of their summed width) that every token passes.  Experts hold at
most ``ceil(tokens * top_k / experts * capacity_factor)`` assignments of a
microbatch, given in the order of (token, k): an assignment past that is
dropped (the token keeps its other experts), GShard's capacity semantics.
The loss adds ``aux_loss_alpha`` times each MoE layer's Switch balance term
E * sum_e(share of assignments_e * mean probability_e), summed over the
layers and divided by ``num_hidden_layers``.  RMSNorms everywhere; the head
is untied.
"""
from __future__ import annotations

import math

import torch

from .common import Layer, Leaf, causal_attention, fan_in_leaf, rms_norm, rope, silu

EMBED_STD = 0.02


class Model:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.rank = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope_dim = cfg["qk_rope_head_dim"]
        self.vd = cfg["v_head_dim"]
        self.v = cfg["vocab_size"]
        self.n_layers = cfg["num_hidden_layers"]
        self.n_dense = cfg["first_k_dense_replace"]
        self.f_dense = cfg["intermediate_size"]
        self.e = cfg["n_routed_experts"]
        self.k = cfg["num_experts_per_tok"]
        self.f_exp = cfg["moe_intermediate_size"]
        self.f_shared = cfg["n_shared_experts"] * self.f_exp
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.capacity_factor = cfg["capacity_factor"]
        self.aux_weight = cfg["aux_loss_alpha"] / self.n_layers
        if cfg["q_lora_rank"] is not None or not cfg["norm_topk_prob"]:
            raise ValueError("this reference takes q_lora_rank null and norm_topk_prob true")
        self.layers = ([Layer("dense0.", i, self._dense_block) for i in range(self.n_dense)]
                       + [Layer("blocks.", i, self._moe_block)
                          for i in range(self.n_layers - self.n_dense)])
        self.head_params = ["final_norm.scale", "lm_head"]

    # -- parameters -------------------------------------------------------------------------
    def _mla_table(self, n: int, prefix: str) -> dict[str, Leaf]:
        d, h, r = self.d, self.h, self.rank
        qk = self.nope + self.rope_dim
        return {
            f"{prefix}mla.kv_norm": Leaf((n, r), "ones"),
            f"{prefix}mla.w_dkv": fan_in_leaf((n, d, r + self.rope_dim), d),
            f"{prefix}mla.w_uk": fan_in_leaf((n, r, h, self.nope), r),
            f"{prefix}mla.w_uv": fan_in_leaf((n, r, h, self.vd), r),
            f"{prefix}mla.wo": fan_in_leaf((n, h, self.vd, d), h * self.vd),
            f"{prefix}mla.wq": fan_in_leaf((n, d, h, qk), d),
        }

    def param_table(self) -> dict[str, Leaf]:
        d, n0, n = self.d, self.n_dense, self.n_layers - self.n_dense
        e, fe, fs, f0 = self.e, self.f_exp, self.f_shared, self.f_dense
        table = {
            "blocks.ln1.scale": Leaf((n, d), "ones"), "blocks.ln2.scale": Leaf((n, d), "ones"),
            **self._mla_table(n, "blocks."),
            "blocks.moe.down": fan_in_leaf((n, e, fe, d), fe),
            "blocks.moe.gate": fan_in_leaf((n, e, d, fe), d),
            "blocks.moe.router": fan_in_leaf((n, d, e), d),
            "blocks.moe.shared_down": fan_in_leaf((n, fs, d), fs),
            "blocks.moe.shared_gate": fan_in_leaf((n, d, fs), d),
            "blocks.moe.shared_up": fan_in_leaf((n, d, fs), d),
            "blocks.moe.up": fan_in_leaf((n, e, d, fe), d),
            "embed": Leaf((self.v, d), "normal", EMBED_STD),
            "final_norm.scale": Leaf((d,), "ones"),
            "lm_head": fan_in_leaf((self.v, d), d),
        }
        if n0:
            table.update({
                "dense0.ln1.scale": Leaf((n0, d), "ones"),
                "dense0.ln2.scale": Leaf((n0, d), "ones"),
                **self._mla_table(n0, "dense0."),
                "dense0.mlp.down": fan_in_leaf((n0, f0, d), f0),
                "dense0.mlp.gate": fan_in_leaf((n0, d, f0), d),
                "dense0.mlp.up": fan_in_leaf((n0, d, f0), d),
            })
        return dict(sorted(table.items()))

    def active_matmul_params(self) -> int:
        """Weights a token multiplies in one forward pass: each layer's MLA
        products, the dense layers' MLP, the router, its top-k routed experts
        and the shared experts of each MoE layer, and the head (the embedding
        lookup is no product)."""
        d, h, r = self.d, self.h, self.rank
        mla = (d * h * (self.nope + self.rope_dim) + d * (r + self.rope_dim)
               + r * h * self.nope + r * h * self.vd + h * self.vd * d)
        dense = mla + 3 * d * self.f_dense
        moe = mla + d * self.e + self.k * 3 * d * self.f_exp + 3 * d * self.f_shared
        return self.n_dense * dense + (self.n_layers - self.n_dense) * moe + self.v * d

    def attention(self) -> dict:
        return {"layers": self.n_layers, "heads": self.h, "kv_heads": self.h,
                "qk_dim": self.nope + self.rope_dim, "v_dim": self.vd}

    # -- the model ----------------------------------------------------------------------------
    def embed(self, params, tokens):
        return params["embed"][tokens]

    def embed_backward(self, grads, tokens, gh):
        grads["embed"].index_add_(0, tokens.reshape(-1), gh.reshape(-1, self.d))

    def _mla(self, p, x, prec):
        dkv = prec.matmul(x, p["mla.w_dkv"])
        c_kv = rms_norm(dkv[..., :self.rank], p["mla.kv_norm"], self.eps)
        k_rope = rope(dkv[..., None, self.rank:], self.theta)  # (B, S, 1, rope)
        q = prec.einsum("bsd,dhk->bshk", x, p["mla.wq"])
        q = torch.cat([q[..., :self.nope], rope(q[..., self.nope:], self.theta)], dim=-1)
        k_nope = prec.einsum("bsr,rhk->bshk", c_kv, p["mla.w_uk"])
        v = prec.einsum("bsr,rhk->bshk", c_kv, p["mla.w_uv"])
        k = torch.cat([k_nope, k_rope.expand(-1, -1, self.h, -1)], dim=-1)
        o = causal_attention(q, k, v, 1.0 / math.sqrt(self.nope + self.rope_dim), prec)
        return prec.einsum("bshk,hkd->bsd", o, p["mla.wo"])

    def _swiglu(self, x, gate, up, down, prec):
        return prec.matmul(silu(prec.matmul(x, gate)) * prec.matmul(x, up), down)

    def _dense_block(self, p, h, prec):
        h = h + self._mla(p, rms_norm(h, p["ln1.scale"], self.eps), prec)
        x = rms_norm(h, p["ln2.scale"], self.eps)
        return h + self._swiglu(x, p["mlp.gate"], p["mlp.up"], p["mlp.down"], prec), None

    def _moe(self, p, x, prec):
        b, s, d = x.shape
        xf = x.reshape(-1, d)
        t = xf.shape[0]
        probs = torch.softmax(prec.matmul(xf, p["moe.router"]), dim=-1)  # (T, E)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :self.k], idx[:, :self.k]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        flat = idx.reshape(-1)
        counts = torch.bincount(flat, minlength=self.e)
        aux = self.e * torch.sum(counts.float() / flat.numel() * probs.mean(0))
        capacity = max(int(math.ceil(t * self.k / self.e * self.capacity_factor)), self.k)
        # each assignment's place among its expert's, in (token, k) order
        order = torch.argsort(flat, stable=True)
        start = torch.cumsum(counts, 0) - counts
        place = torch.empty_like(flat)
        place[order] = torch.arange(flat.numel(), device=x.device) - start[flat[order]]
        kept = place < capacity
        out = torch.zeros_like(xf)
        token = torch.arange(flat.numel(), device=x.device) // self.k
        wf = w.reshape(-1)
        for e in range(self.e):
            sel = torch.nonzero((flat == e) & kept)[:, 0]
            if sel.numel() == 0:
                continue
            tok = token[sel]
            y = self._swiglu(xf[tok], p["moe.gate"][e], p["moe.up"][e], p["moe.down"][e], prec)
            out = out.index_add(0, tok, y * wf[sel, None])
        out = out + self._swiglu(xf, p["moe.shared_gate"], p["moe.shared_up"],
                                 p["moe.shared_down"], prec)
        return out.reshape(b, s, d), aux

    def _moe_block(self, p, h, prec):
        h = h + self._mla(p, rms_norm(h, p["ln1.scale"], self.eps), prec)
        out, aux = self._moe(p, rms_norm(h, p["ln2.scale"], self.eps), prec)
        return h + out, aux

    def logits(self, head, hc, prec):
        return prec.matmul(rms_norm(hc, head["final_norm.scale"], self.eps), head["lm_head"].t())
