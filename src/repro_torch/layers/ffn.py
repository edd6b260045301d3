"""Feed-forward layers: the gated MLP and mixture of experts (port of
``repro/layers/ffn.py``).

With projection fusion (``CompressionConfig.fuse_projections``) a gated
block-circulant MLP runs up and gate as one call against its
``upgate_cache`` planes (``core/circulant.py:bc_matmul_fused``), the
activation on ``gate``, as ``repro`` does; the MoE's shared expert is such
an MLP.  Expert stacks never fuse.

The MoE routes tokens as ``repro`` does: grouped token-choice top-k with a
capacity factor, float32 router logits, one-hot dispatch and combine.
Expert weights are ``(E, ...)`` stacks (``Experts``): per-expert
block-circulant generators (E, p, q, k) when the config sets
``block_expert``, dense (E, d_in, d_out) otherwise.  At serve the
circulant stacks run against their baked (E, p, q, kf) planes through
``kernels/ops.py:bc_expert_linear`` (one fused-kernel launch per
projection for all E experts on the card).  In train mode they run through
``core/circulant.py:bc_matmul_fft`` on the whole stack (``repro``'s
``jax.vmap(bc_matmul_fft)``): on the card one fused-kernel launch a
projection forward, one for its input gradient and one ``bc_grad_w`` call
for its weight gradient; baked planes are not read.  Train mode also
returns ``repro``'s Switch-style load-balancing loss (``load_balance``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import circulant as cc
from ..core.circulant import Linear, LinearSpec
from ..kernels import ops as kops

EXPERT_PROJECTIONS = ("up", "gate", "down")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                     # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(f"activation {name!r}")


class MLP(cc.FusedProjections, nn.Module):
    """up / down (and gate) projections, and the fused up/gate planes
    ``upgate_cache_*`` where projection fusion baked them
    (``serve/params.py``)."""
    FUSED_CACHE, FUSED = "upgate_cache", ("up", "gate")

    def __init__(self, d_model: int, d_ff: int, comp=None, gated: bool = True,
                 *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = LinearSpec.from_config(comp, "ffn")
        kw = dict(device=device, generator=generator)
        self.up = Linear(d_model, d_ff, spec, **kw)
        self.down = Linear(d_ff, d_model, spec, **kw)
        self.gate = Linear(d_model, d_ff, spec, **kw) if gated else None
        cc.register_planes(self, self.FUSED_CACHE)


def mlp(m: MLP, x: torch.Tensor, *, activation: str = "silu",
        mode: str = "serve", kernel_fn=None, comp=None) -> torch.Tensor:
    """``kernel_fn`` is the spectral-MAC hook of the three projections
    (``core/circulant.py``); ``comp`` (the config's compression) says
    whether up and gate fuse."""
    if (m.gate is not None and getattr(comp, "fuse_projections", False)
            and m.up.spec.kind == "block_circulant"):
        up, gate = m.fused(x, mode, kernel_fn)
        up = _act(activation, gate) * up
    elif m.gate is not None:
        up = m.up(x, mode, kernel_fn)
        up = _act(activation, m.gate(x, mode, kernel_fn)) * up
    else:
        up = _act(activation, m.up(x, mode, kernel_fn))
    return m.down(up, mode, kernel_fn)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------
class Experts(nn.Module):
    """The experts' up / gate / down stacks (``repro``'s ``experts``
    dict).  With block size ``k`` each is (E, p, q, k) generators drawn
    like ``repro``'s per-expert ``init_block_circulant``; without, dense
    (E, n_in, n_out) at ``1/sqrt(n_in)``.  ``bake_spectral`` stores each
    stack's planes as buffers ``<proj>_cache_<plane>`` ((E, p, q, kf);
    quantized planes keep (E, p, 1) scales in ``<proj>_cache_<plane>_s``),
    so ``.to()`` moves them with the weights.  Without a ``generator`` the
    weights are zeros, to be filled by ``models/convert.py``."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int, k: int, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_size = k
        dims = {"up": (d_model, d_ff), "gate": (d_model, d_ff),
                "down": (d_ff, d_model)}
        for name, (n_in, n_out) in dims.items():
            shape = ((num_experts, cc.num_blocks(n_out, k),
                      cc.num_blocks(n_in, k), k) if k
                     else (num_experts, n_in, n_out))
            w = (torch.randn(shape, generator=generator, device=device)
                 / math.sqrt(n_in) if generator is not None
                 else torch.zeros(shape, device=device))
            setattr(self, name, nn.Parameter(w, requires_grad=False))
            cc.register_planes(self, f"{name}_cache")

    def cache(self, name: str) -> Optional[Dict[str, torch.Tensor]]:
        return cc.planes_of(self, f"{name}_cache")

    def plane_caches(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Baked caches by buffer prefix (``quant/codec.py:baked_caches``)."""
        return {f"{n}_cache": c for n in EXPERT_PROJECTIONS
                if (c := self.cache(n)) is not None}

    def bake_spectral(self, gauss: bool = True) -> None:
        """Store ``spectral_cache`` of each stack (idempotent)."""
        for name in EXPERT_PROJECTIONS:
            if self.cache(name) is None:
                with torch.no_grad():
                    cc.set_planes(self, f"{name}_cache", cc.spectral_cache(
                        getattr(self, name), gauss))


class MoE(nn.Module):
    """Router ``(d_model, E)``, the expert stacks and the optional shared
    expert (a gated ``MLP`` of the same width), as ``repro``'s
    ``init_moe``."""

    def __init__(self, d_model: int, d_ff: int, moe_cfg, comp=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E = moe_cfg.num_experts
        k = (comp.block_for("expert")
             if comp is not None and comp.enabled else 0)
        self.experts = Experts(E, d_model, d_ff, k, device=device,
                               generator=generator)
        router = (torch.randn((d_model, E), generator=generator,
                              device=device) / math.sqrt(d_model)
                  if generator is not None
                  else torch.zeros((d_model, E), device=device))
        self.router = nn.Parameter(router, requires_grad=False)
        self.shared = (MLP(d_model, d_ff, comp, device=device,
                           generator=generator)
                       if moe_cfg.shared_expert else None)
        # the smallest router logit gap seen (a 0-dim device tensor, updated
        # in place), or None: not recorded.  See ``moe``.
        self.logit_gap: Optional[torch.Tensor] = None


def _expert_ffn(ex: Experts, xe: torch.Tensor, activation: str, d_ff: int,
                d_model: int, gauss: bool, mode: str) -> torch.Tensor:
    """xe: (E, cap, d_model) -> (E, cap, d_model), each expert's rows
    through its own weights.  Circulant stacks take their baked planes at
    serve (derived on the fly where none are baked) and their generators
    through ``bc_matmul_fft`` in train mode; ``repro`` takes no
    spectral-MAC hook here, so neither does the port."""
    k = ex.block_size
    if not k:
        up = torch.einsum("ecd,edf->ecf", xe, ex.up.to(xe.dtype))
        gate = torch.einsum("ecd,edf->ecf", xe, ex.gate.to(xe.dtype))
        h = _act(activation, gate) * up
        return torch.einsum("ecf,efd->ecd", h, ex.down.to(xe.dtype))

    def proj(name, x, n_out):
        if mode == "train":
            return cc.bc_matmul_fft(x, getattr(ex, name), n_out, gauss)
        cache = ex.cache(name)
        if cache is None:
            cache = cc.spectral_cache(getattr(ex, name), gauss)
        return kops.bc_expert_linear(x, cache, k, n_out, gauss)

    h = _act(activation, proj("gate", xe, d_ff)) * proj("up", xe, d_ff)
    return proj("down", h, d_model)


def route(router: torch.Tensor, xt: torch.Tensor, E: int, topk: int,
          cap: int):
    """Grouped top-k routing of ``repro``'s ``moe``.  xt: (G, g, d).
    Returns the dispatch and combine tensors (G, g, E, cap) in xt.dtype,
    the chosen experts (G, g, topk) and the float32 router logits
    (G, g, E):
    float32 router logits, softmax, top-k, gates renormalised to sum 1;
    each (token, choice) takes the next free position of its expert's
    capacity buffer in token order (a cumsum), and a choice past ``cap``
    is dropped."""
    return route_logits(torch.einsum("gtd,de->gte", xt.float(),
                                     router.float()), xt, E, topk, cap)


def route_logits(logits: torch.Tensor, xt: torch.Tensor, E: int, topk: int,
                 cap: int):
    """``route`` from the float32 router logits (G, g, E) of xt."""
    G, g, _ = xt.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, topk, dim=-1)     # (G, g, topk)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx, E)                           # (G,g,topk,E)
    flat = onehot.reshape(G, g * topk, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(G, g, topk)
    slots = torch.arange(cap, device=xt.device)
    # one_hot(pos, cap) is all zero where pos >= cap: the choice is dropped
    disp = (onehot.to(xt.dtype)[..., :, None]
            * (pos[..., None] == slots).to(xt.dtype)[..., None, :])
    comb = disp * gate_vals[..., None, None].to(xt.dtype)
    return disp.sum(2), comb.sum(2), gate_idx, logits


def load_balance(gate_idx: torch.Tensor, logits: torch.Tensor, E: int
                 ) -> torch.Tensor:
    """``repro``'s Switch-style auxiliary loss: the fraction of each
    group's ``g * topk`` choices that picked expert e (dropped choices
    included) times its mean router probability, summed over e, averaged
    over the groups, times E.  The gradient reaches the router through
    the probabilities."""
    G, g, topk = gate_idx.shape
    density = F.one_hot(gate_idx, E).reshape(G, g * topk, E).float().mean(1)
    router_prob = torch.softmax(logits, dim=-1).mean(1)
    return (density * router_prob).sum(-1).mean() * E


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """The smallest gap between a token's two largest router logits: a
    token whose gap is under the logits' rounding error may route
    otherwise under another lowering."""
    top = torch.topk(logits, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min()


def moe(m: MoE, x: torch.Tensor, *, d_ff: int, moe_cfg, comp=None,
        activation: str = "silu", mode: str = "serve",
        kernel_fn=None):
    """Grouped top-k token-choice MoE, x: (B, S, d) -> (B, S, d); in train
    mode ((B, S, d), aux), aux the float32 ``load_balance`` loss.

    Routing groups of ``g = gcd(min(router_group_size, T), T)`` tokens
    (T = B * S); each expert's buffer holds ``cap = min(ceil(g * topk / E
    * capacity_factor), g)`` tokens a group, and decode at serve (S == 1)
    is dropless, ``cap = g``.  Pad tokens route and take capacity like any
    other, as in ``repro``.  ``kernel_fn`` (the spectral-MAC hook) reaches
    the shared expert only.  The router's gradient flows through the
    renormalised gate values (the combine weights) and through aux, as in
    ``repro``; a choice past ``cap`` is dropped from the dispatch and the
    combine (it carries no gradient) and still counts in aux's density.
    Where ``m.logit_gap`` is a tensor, each serving call folds its
    ``top2_gap`` into it in place (a running minimum on the device, read
    by the caller after the dispatch): no host read happens in the call,
    so it runs inside a captured decode step, whose replays update the
    tensor that was there at capture.  Train mode never updates it (under
    ``checkpoint`` the recompute would fold it twice)."""
    B, S, d = x.shape
    E, topk = moe_cfg.num_experts, moe_cfg.top_k
    g, G, cap = groups(B * S, S, moe_cfg, mode)
    gauss = comp.gauss_trick if comp is not None else True

    xt = x.reshape(G, g, d)
    disp, comb, gate_idx, logits = route(m.router, xt, E, topk,
                                         cap)                  # (G,g,E,cap)
    if m.logit_gap is not None and mode != "train":
        torch.minimum(m.logit_gap, top2_gap(logits), out=m.logit_gap)
    xe = torch.einsum("gtd,gtec->gecd", xt, disp)             # (G,E,cap,d)
    xe = xe.transpose(0, 1).reshape(E, G * cap, d)
    ye = _expert_ffn(m.experts, xe, activation, d_ff, d, gauss, mode)
    ye = ye.reshape(E, G, cap, d).transpose(0, 1)             # (G,E,cap,d)
    out = torch.einsum("gecd,gtec->gtd", ye, comb)
    if m.shared is not None:
        out = out + mlp(m.shared, xt, activation=activation, mode=mode,
                        kernel_fn=kernel_fn, comp=comp)
    out = out.reshape(B, S, d)
    if mode == "train":
        return out, load_balance(gate_idx, logits, E)
    return out


def groups(T: int, S: int, moe_cfg, mode: str):
    """(g, G, cap) of ``moe``'s routing over T tokens of length-S rows:
    G groups of g tokens, each expert taking ``cap`` of a group's."""
    g = math.gcd(min(moe_cfg.router_group_size, T), T)
    cap = max(1, int(math.ceil(g * moe_cfg.top_k / moe_cfg.num_experts
                               * moe_cfg.capacity_factor)))
    cap = min(cap, g)
    if mode == "serve" and S == 1:
        cap = g                  # dropless decode: every token one expert
    return g, T // g, cap
