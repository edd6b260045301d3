"""AdamW with optional int8 moments (port of ``repro/optim/adamw.py``).

``repro`` holds each segment's parameters stacked over its scan axis, and
three of its rules act on a stacked leaf: weight decay ``if p.ndim >= 2``
(so every in-block norm scale and qwen's biases decay, ``final_norm`` does
not), and the per-tensor absmax scales of the int8 / uint8 moments (one
scale over all the layers of a segment).  The port keeps one module a
layer, so it works on ``Leaf``s: a ``repro`` leaf's name, its list of
per-layer tensors and its stacked rank (``train/train_step.py:
param_leaves`` builds them), and it decides decay by that rank and takes
one scale over the list.  Gradients, moments and new values are lists of
lists in the order of the leaves.

The moment store is ``{"mv": [per leaf: {"m": [...], "v": [...]} or, int8,
{"m": [int8], "m_s": scalar, "v": [uint8], "v_s": scalar}], "count":
int32 scalar}``; every tensor lives on the parameters' device, and a
moment has its parameter's layout (a sharded parameter's moments are
sharded alike).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False


class Leaf(NamedTuple):
    """One ``repro`` parameter leaf: its tree path, the port's per-layer
    tensors that stack into it, and the stacked leaf's rank."""
    name: str
    tensors: Tensors
    rank: int


# ---------------------------------------------------------------------------
# int8 moment codec, one absmax scale over a leaf's tensors
# ---------------------------------------------------------------------------
def _absmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.abs().amax() for x in xs]).amax()


def _scale(absmax: torch.Tensor, levels: float) -> torch.Tensor:
    """``max(absmax, 1e-12) / levels`` as a true division on every device:
    CUDA divides by a host scalar as a product with its reciprocal, which
    can land one ulp off the CPU's and ``repro``'s quotient (and move a
    code at a rounding boundary), so the divisor is a tensor beside it."""
    return torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, levels)


def q_sym(xs: Sequence[torch.Tensor]) -> Tuple[Tensors, torch.Tensor]:
    """Symmetric int8 with one absmax scale (for m, sign-carrying)."""
    scale = _scale(_absmax(xs), 127.0)
    return ([torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
             for x in xs], scale)


def dq_sym(qs: Sequence[torch.Tensor], scale: torch.Tensor) -> Tensors:
    return [q.float() * scale for q in qs]


def q_pos(xs: Sequence[torch.Tensor]) -> Tuple[Tensors, torch.Tensor]:
    """uint8 sqrt-companded codec for the non-negative second moment."""
    rs = [torch.sqrt(torch.clamp(x, min=0.0)) for x in xs]
    scale = _scale(_absmax(rs), 255.0)
    return ([torch.clamp(torch.round(r / scale), 0, 255).to(torch.uint8)
             for r in rs], scale)


def dq_pos(qs: Sequence[torch.Tensor], scale: torch.Tensor) -> Tensors:
    out = []
    for q in qs:
        r = q.float() * scale
        out.append(r * r)
    return out


# ---------------------------------------------------------------------------
def init(leaves: Sequence[Leaf], cfg: AdamWConfig) -> dict:
    device = leaves[0].tensors[0].device
    mv = []
    for leaf in leaves:
        if cfg.quantize_moments:
            mv.append({
                "m": [torch.zeros_like(t, dtype=torch.int8)
                      for t in leaf.tensors],
                "m_s": torch.zeros((), device=device),
                "v": [torch.zeros_like(t, dtype=torch.uint8)
                      for t in leaf.tensors],
                "v_s": torch.zeros((), device=device)})
        else:
            mv.append({"m": [torch.zeros_like(t, dtype=torch.float32)
                             for t in leaf.tensors],
                       "v": [torch.zeros_like(t, dtype=torch.float32)
                             for t in leaf.tensors]})
    return {"mv": mv,
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient element's square (float32)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for gs in grads for g in gs))


def update(grads: Sequence[Tensors], state: dict, leaves: Sequence[Leaf],
           cfg: AdamWConfig, lr=None) -> Tuple[List[Tensors], dict]:
    """One AdamW step: clip by the global norm, bias-correct, decay leaves
    of stacked rank >= 2.  Returns (new tensors per leaf, new state); the
    caller decides whether to keep them (the non-finite guard)."""
    count = state["count"] + 1
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    c2 = 1.0 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    new_params, new_mv = [], []
    for gs, leaf, mv in zip(grads, leaves, state["mv"]):
        if cfg.quantize_moments:
            ms, vs = dq_sym(mv["m"], mv["m_s"]), dq_pos(mv["v"], mv["v_s"])
        else:
            ms, vs = mv["m"], mv["v"]
        decay = cfg.weight_decay if leaf.rank >= 2 else 0.0
        ps, m_out, v_out = [], [], []
        for g, p, m, v in zip(gs, leaf.tensors, ms, vs):
            g = g.float() * clip
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = p.detach().float()
            ps.append((pf - lr * (upd + decay * pf)).to(p.dtype))
            m_out.append(m)
            v_out.append(v)
        if cfg.quantize_moments:
            mq, m_s = q_sym(m_out)
            vq, v_s = q_pos(v_out)
            new_mv.append({"m": mq, "m_s": m_s, "v": vq, "v_s": v_s})
        else:
            new_mv.append({"m": m_out, "v": v_out})
        new_params.append(ps)
    return new_params, {"mv": new_mv, "count": count}


def select(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` (a device bool) holds, else ``old``: any
    nesting of dicts and lists of tensors, selected on the device."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: select(ok, new[k], old[k]) for k in new}
    return [select(ok, n, o) for n, o in zip(new, old)]
