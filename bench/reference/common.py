"""Plain float32 PyTorch pieces the reference models share.

Nothing here imports the program under test.  A model module (one per
family, beside this file) describes its parameters (:class:`Leaf`), its
embedding, its layers and its head; :func:`microbatch_grads` runs a
microbatch layer by layer (each layer's input kept, the layer recomputed
under autograd in the backward pass, so that one layer's activations are
held at a time) and :func:`adamw_update` is AdamW with global-norm
clipping, step for step the update rule the training loop states.

``Precision("fp8")`` is the control: every product's operands, its output
and, in the backward pass, its incoming gradient rounded to float8 e4m3
with one scale per tensor (accumulated in float32 within the product);
``Precision("f32")`` is the reference itself.  Callers turn TF32 off (:func:`strict_f32`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

E4M3_MAX = 448.0  # the largest finite float8 e4m3fn value


def strict_f32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and how the benchmark draws it (``normal``
    with standard deviation ``std``, ``zeros`` or ``ones``)."""

    shape: tuple[int, ...]
    init: str = "normal"
    std: float = 0.0


def fan_in_leaf(shape: tuple[int, ...], contracted: int) -> Leaf:
    """A weight drawn with standard deviation 1/sqrt(the product of the dims
    its product contracts): unit-variance inputs give unit-variance outputs."""
    return Leaf(tuple(shape), "normal", 1.0 / math.sqrt(contracted))


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (its largest magnitude
    maps to 448) and back to its own dtype."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _RoundIn(torch.autograd.Function):
    """Forward: the operand rounded to fp8; backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x):
        return fake_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Forward: unchanged; backward: the incoming gradient rounded to fp8, so
    that the backward products read fp8 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fake_fp8(g)


class Precision:
    """``"f32"``: the reference; ``"fp8"``: the control (module docstring)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}: f32 or fp8")
        self.name = name
        self.fp8 = name == "fp8"

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return torch.einsum(eq, a, b)
        out = torch.einsum(eq, _RoundIn.apply(a), _RoundIn.apply(b))
        return _RoundGrad.apply(_RoundIn.apply(out))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return a @ b
        return _RoundGrad.apply(_RoundIn.apply(_RoundIn.apply(a) @ _RoundIn.apply(b)))

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product taken outside autograd."""
        return fake_fp8(x) if self.fp8 else x


# -- norms, RoPE, activations ------------------------------------------------------------------
def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, d) at positions 0..S-1: the first and
    second halves of each head vector rotated as pairs (i, i + d/2)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv  # (S, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3))))


def silu(x):
    return x * torch.sigmoid(x)


# -- causal attention, by blocks of queries --------------------------------------------------
QUERY_BLOCK_BYTES = 512 * 2**20  # one block's (B, H, rows, keys) f32 scores


def _rows_per_block(b: int, h: int, s: int) -> int:
    return max(16, min(s, QUERY_BLOCK_BYTES // (4 * b * h * s)))


class _CausalAttention(torch.autograd.Function):
    """softmax(Q K^T * scale, causal) V over blocks of queries, the full score
    matrix never held: the forward keeps each row's log-sum-exp, the backward
    recomputes each block's probabilities from it.  q (B, S, H, dq); k (B, S,
    Hkv, dq); v (B, S, Hkv, dv); query head i reads key/value head i // (H/Hkv)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, prec: Precision):
        b, s, h, _ = q.shape
        g = h // k.shape[2]
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        o = q.new_empty((b, h, s, v.shape[-1]))
        lse = q.new_empty((b, h, s))
        step = _rows_per_block(b, h, s)
        pos = torch.arange(s, device=q.device)
        for i0 in range(0, s, step):
            i1 = min(s, i0 + step)
            sc = prec.q(prec.q(qh[:, :, i0:i1]) @ prec.q(kh[:, :, :i1]).transpose(-1, -2)) * scale
            sc.masked_fill_(pos[i0:i1, None] < pos[None, :i1], float("-inf"))
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            o[:, :, i0:i1] = prec.q(prec.q(p / l) @ prec.q(vh[:, :, :i1]))
            lse[:, :, i0:i1] = (m + torch.log(l))[..., 0]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.prec = scale, prec
        return o.permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, prec = ctx.scale, ctx.prec
        b, s, h, dq = q.shape
        hkv = k.shape[2]
        g = h // hkv
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        doh = do.permute(0, 2, 1, 3)
        if prec.fp8:
            doh = fake_fp8(doh)
        big_d = (doh * o).sum(-1)  # (B, H, S)
        dqh = torch.zeros_like(qh)
        dkh = torch.zeros_like(kh)
        dvh = torch.zeros_like(vh)
        step = _rows_per_block(b, h, s)
        pos = torch.arange(s, device=q.device)
        for i0 in range(0, s, step):
            i1 = min(s, i0 + step)
            qb, kb, vb = prec.q(qh[:, :, i0:i1]), prec.q(kh[:, :, :i1]), prec.q(vh[:, :, :i1])
            sc = qb @ kb.transpose(-1, -2) * scale
            sc.masked_fill_(pos[i0:i1, None] < pos[None, :i1], float("-inf"))
            p = torch.exp(sc - lse[:, :, i0:i1, None])
            dob = doh[:, :, i0:i1]
            dvh[:, :, :i1] += prec.q(p).transpose(-1, -2) @ dob
            dp = dob @ vb.transpose(-1, -2)
            ds = prec.q(p * (dp - big_d[:, :, i0:i1, None]))
            dqh[:, :, i0:i1] = ds @ kb * scale
            dkh[:, :, :i1] += ds.transpose(-1, -2) @ qb * scale
        dk = dkh.reshape(b, hkv, g, s, dq).sum(2).permute(0, 2, 1, 3)
        dv = dvh.reshape(b, hkv, g, s, -1).sum(2).permute(0, 2, 1, 3)
        return dqh.permute(0, 2, 1, 3), dk, dv, None, None


def causal_attention(q, k, v, scale: float, prec: Precision) -> torch.Tensor:
    """(B, S, H, dv): module docstring of :class:`_CausalAttention`."""
    return _CausalAttention.apply(q, k, v, scale, prec)


# -- the layer-by-layer step -------------------------------------------------------------------
@dataclasses.dataclass
class Layer:
    """One layer: ``fn(params_of_the_layer, h) -> (h, aux or None)``, its
    weights the index ``index`` of every stacked leaf under ``prefix``."""

    prefix: str
    index: int
    fn: object


def _layer_params(params: dict, prefix: str, index: int) -> dict:
    return {k[len(prefix):]: v[index].detach().requires_grad_(True)
            for k, v in params.items() if k.startswith(prefix)}


HEAD_CHUNK = 4096  # tokens whose logits the head computes at once


def microbatch_grads(model, params: dict, grads: dict, tokens: torch.Tensor,
                     labels: torch.Tensor, prec: Precision) -> float:
    """The loss of one microbatch (its mean cross-entropy plus the model's
    aux term), its gradient added into ``grads`` (one f32 tensor per leaf)."""
    n_tok = tokens.numel()
    with torch.no_grad():
        h = model.embed(params, tokens)
        inputs, aux_sum = [], 0.0
        for layer in model.layers:
            inputs.append(h)
            h, aux = layer.fn(_layer_params(params, layer.prefix, layer.index), h, prec)
            if aux is not None:
                aux_sum += float(aux)
    # the head, by chunks of tokens: the logits of a chunk at a time
    head_names = model.head_params
    head = {k: params[k].detach().requires_grad_(True) for k in head_names}
    hl = h.detach().reshape(n_tok, -1)
    lab = labels.reshape(-1)
    gh = torch.empty_like(hl)
    xent = 0.0
    for c0 in range(0, n_tok, HEAD_CHUNK):
        hc = hl[c0:c0 + HEAD_CHUNK].detach().requires_grad_(True)
        with torch.enable_grad():
            logits = model.logits(head, hc, prec)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lab[c0:c0 + HEAD_CHUNK, None])[:, 0]
            part = (lse - gold).sum() / n_tok
            part.backward()
        xent += float(part.detach())
        gh[c0:c0 + HEAD_CHUNK] = hc.grad
    for k in head_names:
        grads[k] += head[k].grad
    gh = gh.reshape(h.shape)
    aux_w = model.aux_weight
    for layer, x_in in zip(reversed(model.layers), reversed(inputs)):
        lp = _layer_params(params, layer.prefix, layer.index)
        x = x_in.detach().requires_grad_(True)
        with torch.enable_grad():
            out, aux = layer.fn(lp, x, prec)
            outs, douts = [out], [gh]
            if aux is not None:
                outs.append(aux)
                douts.append(torch.full_like(aux, aux_w))
            torch.autograd.backward(outs, douts)
        for k, t in lp.items():
            if t.grad is not None:
                grads[layer.prefix + k][layer.index] += t.grad
        gh = x.grad
    model.embed_backward(grads, tokens, gh)
    return xent + aux_w * aux_sum


# -- AdamW -----------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int


def global_norm(tree: dict) -> float:
    return math.sqrt(sum(leaf_norm(t) ** 2 for t in tree.values()))


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def adamw_update(cfg: AdamW, step: int, params: dict, grads: dict, m: dict, v: dict) -> dict:
    """One AdamW step, in place: clip by the global norm, bias-corrected
    moments, decoupled weight decay, the learning rate warmed up linearly
    over ``warmup_steps``.  Returns the global norm and, leaf by leaf, the
    norm of the gradient the moments received (after clipping)."""
    gnorm = global_norm(grads)
    scale = min(cfg.grad_clip / max(gnorm, 1e-9), 1.0)
    lr = cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)
    bc1, bc2 = 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step
    clipped = {}
    for k, p in params.items():
        g = grads[k].mul_(scale)
        clipped[k] = leaf_norm(g)
        m[k].mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v[k].mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps)
        upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd, alpha=lr)
        del upd
    return {"grad_norm": gnorm, "leaf_grad_norms": clipped}


def train_steps(model, params: dict, batches, cfg: AdamW, microbatches: int,
                prec: Precision) -> list[dict]:
    """Steps of ``batches`` ((B, S) token and label tensors on the params'
    device), each in ``microbatches`` equal parts of rows, their gradients
    summed and averaged, then AdamW; ``params`` updated in place.  Returns,
    step by step, the loss (the microbatches' mean), the global gradient norm
    and the clipped per-leaf gradient norms."""
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    out = []
    for step, (x, y) in enumerate(batches, start=1):
        for g in grads.values():
            g.zero_()
        rows = x.shape[0] // microbatches
        losses = [microbatch_grads(model, params, grads, x[i * rows:(i + 1) * rows],
                                   y[i * rows:(i + 1) * rows], prec)
                  for i in range(microbatches)]
        for g in grads.values():
            g.div_(microbatches)
        rec = adamw_update(cfg, step, params, grads, m, v)
        out.append({"loss": sum(losses) / microbatches, **rec})
    del grads, m, v
    return out
