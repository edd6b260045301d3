"""Recurrent sequence-mixing cells: recurrentgemma's RG-LRU and xLSTM's
mLSTM and sLSTM (port of ``repro/layers/recurrent.py``).

The RG-LRU's sequence form is ``repro``'s associative scan over (log a,
b) pairs, taken as a log2(S)-step doubling scan vectorised over (B, S,
W) with the same combine; its step form is the same block at S == 1
(the scan then has nothing to combine).  ``repro`` lowers that scan
through XLA, not a Pallas kernel, so the port runs it as PyTorch tensor
operations, on the CPU and on the card alike.

Each cell has a sequence form (prefill) and a step form (decode, S == 1
with a state): the mLSTM's sequence form is ``repro``'s stabilized
chunkwise recurrence with the same chunk, so the float32 sums are taken
in the same order; the sLSTM's is a strictly sequential scan, here a host
loop over the positions with the ``wh`` recurrence a plain matmul.

The cells' projections (RG-LRU: in_x / in_gate / gate_r / gate_i / out;
mLSTM: up / up_gate / q / k / v / out; sLSTM: wx / out) are
block-circulant ``Linear``s, so at serve they run through
the fused kernel, or through ``spectral_matmul`` under the batch
prefill's ``kernel_fn`` hook.  The gate products (the mLSTM's ``ifg``,
the sLSTM's ``wh``) are plain dense matmuls, as in ``repro``.

States are float32 tuples: the RG-LRU's ``(h, conv)`` ((B, W), (B, cw -
1, W); ``repro``'s dict ``{"h", "conv"}``), the mLSTM's ``(C, n, m)``
((B, H, dh, dh), (B, H, dh), (B, H)), the sLSTM's ``(c, n, h, m)``
((B, d) each).  The block functions return the new state; the model
copies it into the cache's tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.circulant import Linear, LinearSpec

_NEG = -1e30
_C = 8.0   # Griffin's fixed recurrence sharpness constant


# ---------------------------------------------------------------------------
# RG-LRU (Griffin): h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)
# ---------------------------------------------------------------------------
class RGLRU(nn.Module):
    """``repro``'s ``init_rglru``: in_x / in_gate (d_model -> W), out (W
    -> d_model), gate_r / gate_i (W -> W), the depthwise causal conv's
    ``conv_w`` (cw, W) and ``conv_b`` (W,), and ``lam`` (W,), the
    recurrence parameter, set so that a = exp(-8 softplus(lam)) runs over
    linspace(0.9, 0.999, W)."""

    def __init__(self, d_model: int, width: int, comp=None,
                 conv_width: int = 4, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = LinearSpec.from_config(comp, "ffn")
        kw = dict(device=device, generator=generator)
        self.in_x = Linear(d_model, width, spec, **kw)
        self.in_gate = Linear(d_model, width, spec, **kw)
        self.out = Linear(width, d_model, spec, **kw)
        conv_w = (torch.randn((conv_width, width), generator=generator,
                              device=device) * 0.1
                  if generator is not None
                  else torch.zeros((conv_width, width), device=device))
        self.conv_w = nn.Parameter(conv_w, requires_grad=False)
        self.conv_b = nn.Parameter(torch.zeros(width, device=device),
                                   requires_grad=False)
        a = torch.linspace(0.9, 0.999, width, dtype=torch.float64)
        lam = torch.log(torch.expm1(-torch.log(a) / _C))  # inverse softplus
        self.lam = nn.Parameter(lam.float().to(device), requires_grad=False)
        self.gate_r = Linear(width, width, spec, **kw)
        self.gate_i = Linear(width, width, spec, **kw)


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, W); w: (cw, W); state: (B, cw - 1,
    W), the inputs before x (zeros without one).  Returns (out in x.dtype,
    the new state: the last cw - 1 rows of the padded input, in x.dtype)."""
    cw, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(cw)) + b
    return out.to(x.dtype), (xp[:, -(cw - 1):] if cw > 1 else None)


def rglru_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0, over axis 1: an
    inclusive doubling scan of (log a, b) pairs combined as ``repro``'s
    associative scan combines them, (la1 + la2, exp(la2) b1 + b2), in
    ceil(log2 S) steps over the whole (B, S, W) tensor."""
    la, h = log_a, b
    d, S = 1, log_a.shape[1]
    while d < S:
        h = torch.cat([h[:, :d], torch.exp(la[:, d:]) * h[:, :-d]
                       + h[:, d:]], dim=1)
        la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return h


def rglru_block(cell: RGLRU, x: torch.Tensor, *, mode: str = "serve",
                state=None, kernel_fn=None):
    """The RG-LRU temporal block, x: (B, S, d) -> ((B, S, d), (h, conv)),
    term for term as ``repro``'s: the input branch through the causal
    conv, the gates in float32, the gated input scaled by sqrt(1 - a^2),
    a carried-in ``h`` folded into step 0, the scan, then ``out`` of h
    times the gelu gate branch."""
    xb = cell.in_x(x, mode, kernel_fn)
    gate = F.gelu(cell.in_gate(x, mode, kernel_fn), approximate="tanh")
    xb, conv_state = causal_conv1d(xb, cell.conv_w, cell.conv_b,
                                   None if state is None else state[1])
    r = torch.sigmoid(cell.gate_r(xb, mode, kernel_fn).float())
    i = torch.sigmoid(cell.gate_i(xb, mode, kernel_fn).float())
    softplus = torch.logaddexp(cell.lam, torch.zeros_like(cell.lam))
    log_a = -_C * softplus * r                               # (B, S, W)
    gated = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-9)) * (
        i * xb.float())
    if state is not None:
        # fold the carried state into the first step: b_0 += a_0 h_prev
        gated[:, 0] = gated[:, 0] + torch.exp(log_a[:, 0]) * state[0].float()
    h = rglru_scan(log_a, gated)
    out = cell.out(h.to(x.dtype) * gate, mode, kernel_fn)
    return out, (h[:, -1], conv_state)


def init_rglru_state(batch: int, width: int, conv_width: int = 4, *,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, width), **f32),
            torch.zeros((batch, conv_width - 1, width), **f32))


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T, chunkwise
# ---------------------------------------------------------------------------
class MLSTMCell(nn.Module):
    """``repro``'s ``init_mlstm``: up / up_gate (d_model -> d_in), q / k /
    v (d_in -> d_in), out (d_in -> d_model), the gate projection ``ifg``
    (d_in, 2 heads) with bias ``ifg_b`` (input gates 0, forget gates
    linspace(3, 6)) and the output norm's ``onorm_scale``."""

    def __init__(self, d_model: int, heads: int, proj_factor: float = 2.0,
                 comp=None, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = LinearSpec.from_config(comp, "ffn")
        d_in = int(d_model * proj_factor)
        kw = dict(device=device, generator=generator)
        self.up = Linear(d_model, d_in, spec, **kw)
        self.up_gate = Linear(d_model, d_in, spec, **kw)
        self.q = Linear(d_in, d_in, spec, **kw)
        self.k = Linear(d_in, d_in, spec, **kw)
        self.v = Linear(d_in, d_in, spec, **kw)
        ifg = (torch.randn((d_in, 2 * heads), generator=generator,
                           device=device) * d_in ** -0.5
               if generator is not None
               else torch.zeros((d_in, 2 * heads), device=device))
        self.ifg = nn.Parameter(ifg, requires_grad=False)
        self.ifg_b = nn.Parameter(torch.cat([
            torch.zeros(heads, device=device),
            torch.linspace(3.0, 6.0, heads, device=device)]),
            requires_grad=False)
        self.out = Linear(d_in, d_model, spec, **kw)
        self.onorm_scale = nn.Parameter(torch.ones(d_in, device=device),
                                        requires_grad=False)


def mlstm_seq(q, k, v, i_pre, f_pre, state=None, chunk: int = 256):
    """Stabilized chunkwise mLSTM.  q/k/v: (B, H, S, dh); gates (B, H, S)
    pre-activations.  Within a chunk the outputs take the quadratic masked
    form; across chunks (C, n, m) is carried.  S must be a multiple of
    ``min(chunk, S)``, as ``repro`` asserts.  Returns (h, (C, n, m))."""
    B, H, S, dh = q.shape
    c = min(chunk, S)
    nc = S // c
    if nc * c != S:
        raise ValueError(f"mLSTM: {S} positions are not a whole number of "
                         f"chunks of {c}")
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), _NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    scale = dh ** -0.5
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    hs = []
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        qc = q[:, :, sl].float() * scale
        kc = k[:, :, sl].float()
        vc = v[:, :, sl].float()
        lf, li = logf[..., sl], logi[..., sl]
        Fc = torch.cumsum(lf, dim=-1)                   # (B, H, c)
        # decay of the carried state to position t: exp(F_t); gate of
        # source s -> t: exp(F_t - F_s + li_s) for s <= t
        dmat = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, float("-inf")))
        m_intra = dmat.amax(-1)
        m_inter = Fc + m[..., None]
        m_new = torch.maximum(m_intra, m_inter)
        dmat = torch.exp(dmat - m_new[..., None])
        inter = torch.exp(m_inter - m_new)
        s_intra = torch.einsum("bhtd,bhsd->bhts", qc, kc) * dmat
        # C is (v-dim d, k-dim e): q contracts with the k index
        h_num = (torch.einsum("bhts,bhsd->bhtd", s_intra, vc)
                 + torch.einsum("bhte,bhde->bhtd", qc, C) * inter[..., None])
        norm = (s_intra.sum(-1)
                + torch.einsum("bhte,bhe->bht", qc, n) * inter)
        hs.append(h_num / torch.maximum(norm.abs(),
                                        torch.exp(-m_new))[..., None])
        Ftot = Fc[..., -1]
        m_next = torch.maximum(Ftot + m,
                               (Ftot[..., None] - Fc + li).amax(-1))
        decay = torch.exp(Ftot + m - m_next)
        src = torch.exp(Ftot[..., None] - Fc + li - m_next[..., None])
        C = (C * decay[..., None, None]
             + torch.einsum("bhs,bhsd,bhse->bhde", src, vc, kc))
        n = n * decay[..., None] + torch.einsum("bhs,bhse->bhe", src, kc)
        m = m_next
    return torch.cat(hs, dim=2), (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """One position.  q/k/v: (B, H, dh); gates (B, H)."""
    C, n, m = state
    dh = q.shape[-1]
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(f_pre.float())
    i_pre = i_pre.float()
    m_new = torch.maximum(logf + m, i_pre)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i_pre - m_new)
    C_new = C * fg[..., None, None] + ig[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])      # (B, H, v-dim d, k-dim e)
    n_new = n * fg[..., None] + ig[..., None] * kf
    num = torch.einsum("bhe,bhde->bhd", qf, C_new)
    denom = torch.maximum(torch.einsum("bhe,bhe->bh", qf, n_new).abs(),
                          torch.exp(-m_new))
    return num / denom[..., None], (C_new, n_new, m_new)


def mlstm_block(cell: MLSTMCell, x: torch.Tensor, *, heads: int,
                mode: str = "serve", state=None, chunk: int = 256,
                kernel_fn=None):
    """The mLSTM residual branch, x: (B, S, d) -> ((B, S, d), state).  S ==
    1 with a state takes the step form; anything else the chunkwise one,
    starting from ``state`` where given."""
    B, S, d = x.shape
    d_in = cell.q.n_in
    dh = d_in // heads
    up = cell.up(x, mode, kernel_fn)
    gate = F.silu(cell.up_gate(x, mode, kernel_fn))
    q = cell.q(up, mode, kernel_fn)
    k = cell.k(up, mode, kernel_fn)
    v = cell.v(up, mode, kernel_fn)
    ifg = up.float() @ cell.ifg + cell.ifg_b
    i_pre, f_pre = ifg[..., :heads], ifg[..., heads:]          # (B, S, H)

    def to_heads(t):
        return t.reshape(B, S, heads, dh).transpose(1, 2)

    if S == 1 and state is not None:
        h, state = mlstm_step(to_heads(q)[:, :, 0], to_heads(k)[:, :, 0],
                              to_heads(v)[:, :, 0], i_pre[:, 0],
                              f_pre[:, 0], state)
        h = h[:, :, None]
    else:
        h, state = mlstm_seq(to_heads(q), to_heads(k), to_heads(v),
                             i_pre.transpose(1, 2), f_pre.transpose(1, 2),
                             state=state, chunk=chunk)
    h = (head_rms(h) * cell.onorm_scale).to(x.dtype)
    return cell.out(h * gate, mode, kernel_fn), state


def head_rms(h: torch.Tensor) -> torch.Tensor:
    """The mLSTM's per-head rms over dh of h (B, H, S, dh), its heads
    merged: (B, S, H dh) float32."""
    B, H, S, dh = h.shape
    hf = h.transpose(1, 2).float()                              # (B,S,H,dh)
    hf = hf * torch.pow(torch.mean(hf * hf, -1, keepdim=True) + 1e-6, -0.5)
    return hf.reshape(B, S, H * dh)


def init_mlstm_state(batch: int, heads: int, dh: int, *,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, heads, dh, dh), **f32),
            torch.zeros((batch, heads, dh), **f32),
            torch.full((batch, heads), _NEG, **f32))


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with exponential gating, a sequential scan
# ---------------------------------------------------------------------------
class SLSTMCell(nn.Module):
    """``repro``'s ``init_slstm``: input projection ``wx`` (d -> 4d), the
    dense recurrence ``wh`` (d, 4d), bias ``b`` and ``out`` (d -> d)."""

    def __init__(self, d_model: int, comp=None, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = LinearSpec.from_config(comp, "ffn")
        kw = dict(device=device, generator=generator)
        self.wx = Linear(d_model, 4 * d_model, spec, **kw)
        wh = (torch.randn((d_model, 4 * d_model), generator=generator,
                          device=device) * d_model ** -0.5
              if generator is not None
              else torch.zeros((d_model, 4 * d_model), device=device))
        self.wh = nn.Parameter(wh, requires_grad=False)
        self.b = nn.Parameter(torch.zeros(4 * d_model, device=device),
                              requires_grad=False)
        self.out = Linear(d_model, d_model, spec, **kw)


def slstm_cell(gates: torch.Tensor, state):
    """gates: (B, 4d) pre-activations [i f z o]; state (c, n, h, m)."""
    c, n, h, m = state
    i_pre, f_pre, z_pre, o_pre = torch.chunk(gates.float(), 4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(logf + m - m_new)
    c_new = fg * c + ig * torch.tanh(z_pre)
    n_new = fg * n + ig
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def slstm_block(cell: SLSTMCell, x: torch.Tensor, *, mode: str = "serve",
                state=None, kernel_fn=None):
    """The sLSTM residual branch, x: (B, S, d) -> ((B, S, d), state): the
    input projection of every position at once, then one cell step per
    position."""
    gx = cell.wx(x, mode, kernel_fn).float()                   # (B, S, 4d)
    h, state = slstm_scan(gx, cell.wh, cell.b, state)
    return cell.out(h.to(x.dtype), mode, kernel_fn), state


def slstm_scan(gx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
               state=None):
    """The sLSTM recurrence over the input gates gx (B, S, 4d), from
    ``state`` (zeros where None) -> (h (B, S, d) float32, state)."""
    B, S, d4 = gx.shape
    if state is None:
        state = init_slstm_state(B, d4 // 4, device=gx.device)
    hs = []
    for t in range(S):
        state = slstm_cell(gx[:, t] + state[2] @ wh + b, state)
        hs.append(state[2])
    return torch.stack(hs, dim=1), state


def init_slstm_state(batch: int, d_model: int, *,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, d_model), **f32)
    return (z, z.clone(), z.clone(), torch.full((batch, d_model), _NEG,
                                                **f32))
