"""Plain float32 reference of the decoder LMs in ``configs/*.json``: a
pre-norm decoder whose every attention and MLP projection is
block-circulant, with a tied head.

It imports only torch, and it reads only what the benchmark made: the
configuration file's sizes and the weights ``lib/model.py:make_weights``
draws from the seed.  Each projection is computed from its generators
with ``torch.fft`` (a circulant block is ``C[r, c] = w[(r - c) mod k]``,
so ``y_i = sum_j irfft(rfft(w_ij) * rfft(x_j))``), attention
materialises its softmax, and every matrix product runs in float32 with
TF32 off.

The layers, as the published models (Qwen3, Phi-3) have them, with the
port's circulant projections in place of the dense ones:

    x = embed[tokens]  (the first num_patches rows zero: the vision stub)
    each layer:  h = rms(x) * (1 + ln1);  q, k, v = C_q h, C_k h, C_v h
                 q, k = rms(q) * (1 + qn), rms(k) * (1 + kn)   (qk_norm)
                 q, k = rope(q), rope(k)   (split halves, theta^(-2i/D))
                 x = x + C_o softmax(q k^T / sqrt(D) + causal) v
                 h = rms(x) * (1 + ln2);  x = x + C_down(silu(C_gate h) * C_up h)
    logits = (rms(x) * (1 + final)) @ embed^T

``round_to`` puts a rounding at every point where the program holds its
compute dtype (embedding output, residual stream, norm outputs,
projection outputs, attention output, the head's operands): None keeps
float32 (the reference), ``fp8_rows`` gives the lower-precision control.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

Q_CHUNK = 1024          # query rows of one attention block (memory)


@contextlib.contextmanager
def exact_float32():
    """Matrix products in true float32 (TF32 off) for the block."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _FP8Rows(torch.autograd.Function):
    """Rounding to float8_e4m3fn with one scale a row (its absmax onto
    448), forward and backward: the value and its gradient each rounded
    as a scaled float8 product would take them."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8_e4m3fn with a scale a row, back in float32: the
    control's precision (its gradient rounded the same way)."""
    return _FP8Rows.apply(x)


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def circulant(x: torch.Tensor, w: torch.Tensor, n_out: int) -> torch.Tensor:
    """x (T, n_in) through the block-circulant matrix of generators w (p,
    q, k): (T, n_out)."""
    p, q, k = w.shape
    T, n_in = x.shape
    if n_in < q * k:
        x = torch.nn.functional.pad(x, (0, q * k - n_in))
    X = torch.fft.rfft(x.view(T, q, k), dim=-1)            # (T, q, kf)
    W = torch.fft.rfft(w, dim=-1)                           # (p, q, kf)
    Y = torch.bmm(X.permute(2, 0, 1), W.permute(2, 1, 0))   # (kf, T, p)
    y = torch.fft.irfft(Y.permute(1, 2, 0), n=k, dim=-1)    # (T, p, k)
    return y.reshape(T, p * k)[:, :n_out]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (T, H, D) at positions 0..T-1."""
    T, _, D = x.shape
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention over one sequence, q (T, H, D), k / v (T,
    Hkv, D): (T, H*D); query head h reads KV head h // (H / Hkv)."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(T, Hkv, G, D)
    keys = torch.arange(T, device=q.device)
    outs = []
    for r0 in range(0, T, Q_CHUNK):
        r1 = min(T, r0 + Q_CHUNK)
        s = torch.einsum("rhgd,khd->hgrk", qg[r0:r1], k[:r1]) / math.sqrt(D)
        mask = keys[None, :r1] > torch.arange(r0, r1, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("hgrk,khd->rhgd", p, v[:r1]))
    return torch.cat(outs).reshape(T, H * D)


def layer(weights: Dict[str, torch.Tensor], cfg: Dict, i: int,
          x: torch.Tensor, B: int, r: Callable) -> torch.Tensor:
    """Layer ``i`` over x (B*T, d), B sequences of T positions each."""
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = head_dim(cfg)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    T = x.shape[0] // B
    w = lambda name: weights[f"blocks.{i}.{name}"]  # noqa: E731
    h = r(rms(x, w("ln1.scale"), eps))
    q = r(circulant(h, w("attn.q.wc"), H * D)).view(B, T, H, D)
    k = r(circulant(h, w("attn.k.wc"), Hkv * D)).view(B, T, Hkv, D)
    v = r(circulant(h, w("attn.v.wc"), Hkv * D)).view(B, T, Hkv, D)
    if cfg.get("qk_norm"):
        q = r(rms(q, w("attn.qn.scale"), eps))
        k = r(rms(k, w("attn.kn.scale"), eps))
    a = torch.cat([r(attention(r(rope(q[b], theta)), r(rope(k[b], theta)),
                               v[b])) for b in range(B)])
    x = r(x + r(circulant(a, w("attn.o.wc"), d)))
    h = r(rms(x, w("ln2.scale"), eps))
    up = r(circulant(h, w("mlp.up.wc"), cfg["intermediate_size"]))
    gate = r(circulant(h, w("mlp.gate.wc"), cfg["intermediate_size"]))
    f = r(torch.nn.functional.silu(gate) * up)
    return r(x + r(circulant(f, w("mlp.down.wc"), d)))


def hidden(weights: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
           round_to: Optional[Callable] = None,
           checkpoint: bool = False) -> torch.Tensor:
    """The final norm's output (B*T, d) for tokens (B, T); with
    ``checkpoint`` each layer keeps only its input for the backward."""
    r = round_to or (lambda t: t)
    B, T = tokens.shape
    x = weights["embed.table"][tokens.reshape(-1)]
    n_patch = cfg["frontend"]["num_patches"]
    if n_patch:                               # the stub's zero patches
        keep = (torch.arange(T, device=x.device) >= n_patch).repeat(B)
        x = x * keep[:, None]
    x = r(x)
    for i in range(cfg["num_hidden_layers"]):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                layer, weights, cfg, i, x, B, r, use_reentrant=False)
        else:
            x = layer(weights, cfg, i, x, B, r)
    return r(rms(x, weights["final_norm.scale"], float(cfg["rms_norm_eps"])))


def forward(weights: Dict[str, torch.Tensor], cfg: Dict,
            tokens: torch.Tensor, start: int,
            round_to: Optional[Callable] = None) -> torch.Tensor:
    """Logits (T - start, vocab) at positions ``start`` .. T-1 of one
    sequence ``tokens`` (T,), float32."""
    r = round_to or (lambda t: t)
    with exact_float32():
        x = hidden(weights, cfg, tokens[None], round_to)
        return x[start:] @ r(weights["embed.table"]).T


def train_loss(weights: Dict[str, torch.Tensor], cfg: Dict,
               tokens: torch.Tensor, labels: torch.Tensor, zloss: float,
               round_to: Optional[Callable] = None) -> torch.Tensor:
    """The training loss of a batch (B, T): the mean token cross entropy
    over the vocabulary, plus ``zloss`` times the mean squared
    log-partition; differentiable (each layer checkpointed)."""
    r = round_to or (lambda t: t)
    x = hidden(weights, cfg, tokens, round_to, checkpoint=True)
    logits = x @ r(weights["embed.table"]).T
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(1, labels.reshape(-1, 1).long())[:, 0]
    return nll.mean() + zloss * (lse * lse).mean()
