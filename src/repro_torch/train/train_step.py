"""Training step: loss, gradient accumulation, non-finite guard, AdamW
(port of ``repro/train/train_step.py``).

``make_train_step(cfg, opt_cfg, ...)`` returns a ``TrainStep``: calling it
with ``(state, batch)`` takes one step and returns ``(state, metrics)``.
``state`` is ``{"model", "opt", "step", "skipped"}`` (plus ``"ef"`` with
gradient compression and ``"rho"`` in Bayesian mode), built by
``init_state``.  The port updates the model's parameters and the state in
place (``repro`` returns a new tree).

* Gradients are taken with ``torch.autograd.grad`` over ``param_leaves``:
  ``repro``'s parameter leaves (a segment's leaf stacks its layers), each
  the list of the port's per-layer tensors, so AdamW, int8 moments and
  gradient compression act on ``repro``'s leaves (``optim/adamw.py``).
* ``accum`` microbatches: the batch's rows split ``accum`` ways, gradients
  and metrics summed, then scaled by ``1 / accum``.
* The non-finite guard: a step whose gradient norm or loss is not finite
  keeps the old parameters, moments (and error feedback) and adds one to
  ``state["skipped"]``; both are selects on the device, with no host read.
* Bayesian mode (``core/bayesian.py``): the weights are sampled per step
  from a generator seeded with the step (the one host read of that mode)
  and the loss adds KL / num_examples.
* Baked spectral planes go stale when the generators change: a step drops
  them (``core/circulant.py:drop_planes``), and serving bakes them again.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core import bayesian
from ..core.circulant import drop_planes
from ..models.registry import Model, build_model
from ..models.transformer import segments_for
from ..optim import adamw, grad_compression
from ..optim.adamw import Leaf


CE_CHUNK_FLOATS = 1 << 28     # float32 logits of one cross-entropy chunk


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Sums over rows of (-log p(label), lse^2) in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).sum(), torch.square(lse).sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  zloss: float = 0.0) -> torch.Tensor:
    """Mean token NLL in float32, plus ``zloss`` times the mean squared
    log-partition (``repro``'s z-loss).  The label's logit is gathered
    (``repro`` contracts a one-hot: the same value).  Past
    ``CE_CHUNK_FLOATS`` float32 logits the rows go through in chunks of
    at most that many, each under ``checkpoint`` where the logits take a
    gradient: the backward keeps the logits in their own dtype and makes
    one chunk's float32 copy at a time (at gemma2-9b's 9,216 x 256,000
    logits, 1 GB instead of ~28 GB of float32 copies and their
    gradients)."""
    V = logits.shape[-1]
    flat, lab = logits.reshape(-1, V), labels.reshape(-1)
    rows = max(1, CE_CHUNK_FLOATS // V)
    remat = (torch.is_grad_enabled() and logits.requires_grad
             and flat.shape[0] > rows)
    nll = zsq = 0.0
    for r0 in range(0, flat.shape[0], rows):
        part = (flat[r0:r0 + rows], lab[r0:r0 + rows])
        a, b = (checkpoint(_ce_sums, *part, use_reentrant=False) if remat
                else _ce_sums(*part))
        nll, zsq = nll + a, zsq + b
    nll = nll / flat.shape[0]
    if zloss:
        nll = nll + zloss * (zsq / flat.shape[0])
    return nll


def _path(name: str) -> str:
    """A port parameter name as ``repro``'s tree path (``models/convert.py``
    maps the one name that differs, a decoder block's ``self``)."""
    return "/".join("self" if part == "self_attn" else part
                    for part in name.split("."))


def _stacked(blocks: nn.ModuleList, first: int, stride: int, n: int,
             prefix: str) -> List[Leaf]:
    """The leaves of the layers ``first``, ``first + stride``, ... (``n``
    of them) stacked on a scan axis: each of their parameters as one leaf
    ``<prefix>/<path>`` of rank one more than a layer's."""
    return [Leaf(f"{prefix}/{_path(name)}",
                 [blocks[first + g * stride].get_parameter(name)
                  for g in range(n)], p.dim() + 1)
            for name, p in blocks[first].named_parameters()]


def param_leaves(model: nn.Module, cfg: ArchConfig) -> List[Leaf]:
    """``repro``'s parameter leaves in the port's modules, by ``repro``'s
    tree paths: the unstacked parameters (``embed/table``,
    ``final_norm/*``; an encoder-decoder's ``enc_pos/pos``,
    ``dec_pos/pos`` and ``enc_norm/*`` too), one tensor each of their own
    rank; then the stacked ones, the tensor of every layer of a scan, of
    rank one more than a layer's (the scan axis): each segment's
    ``segments/<si>/<bi>/<path>`` (pattern position bi; the expert stacks,
    router and shared expert of an MoE block, the RG-LRU's and the
    xLSTM cells' leaves, gemma2's sandwich norms among them), or an
    encoder-decoder's ``enc_blocks/<path>`` and ``dec_blocks/<path>``."""
    stacks = ("enc_blocks", "dec_blocks") if cfg.is_encoder_decoder \
        else ("blocks",)
    leaves = [Leaf(_path(name), [p], p.dim())
              for name, p in model.named_parameters()
              if name.split(".")[0] not in stacks]
    if cfg.is_encoder_decoder:
        for name in stacks:
            blocks = getattr(model, name)
            leaves += _stacked(blocks, 0, 1, len(blocks), name)
        return leaves
    layer = 0
    for si, (pattern, n) in enumerate(segments_for(cfg)):
        for bi in range(len(pattern)):
            leaves += _stacked(model.blocks, layer + bi, len(pattern), n,
                               f"segments/{si}/{bi}")
        layer += n * len(pattern)
    return leaves


def state_leaves(state: Dict, cfg: ArchConfig) -> List[Leaf]:
    """The leaves the optimizer steps: ``param_leaves``, and in Bayesian
    mode each as ``<leaf>/mu`` then ``<leaf>/rho`` (``repro``'s
    ``{"mu", "rho"}`` leaf dicts)."""
    leaves = param_leaves(state["model"], cfg)
    if "rho" not in state:
        return leaves
    names = {id(p): n for n, p in state["model"].named_parameters()}
    out = []
    for leaf in leaves:
        out.append(leaf._replace(name=f"{leaf.name}/mu"))
        out.append(Leaf(f"{leaf.name}/rho",
                        [state["rho"][names[id(t)]] for t in leaf.tensors],
                        leaf.rank))
    return out


def init_state(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
               seed: int = 0, device=None, model: Optional[nn.Module] = None,
               compress_grads: bool = False,
               bayesian_mode: bool = False) -> Dict:
    """Random weights from ``seed`` (or ``model``), with grads turned on
    for its parameters, zero moments and counters on its device."""
    if model is None:
        model = build_model(cfg).init(seed=seed, device=device)
    model.requires_grad_(True)
    dev = next(model.parameters()).device
    state = {"model": model,
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "skipped": torch.zeros((), dtype=torch.int32, device=dev)}
    if bayesian_mode:
        rho = bayesian.init_bayesian(dict(model.named_parameters()))
        state["rho"] = {n: leaf["rho"].requires_grad_(True)
                        for n, leaf in rho.items()}
    leaves = state_leaves(state, cfg)
    state["opt"] = adamw.init(leaves, opt_cfg)
    if compress_grads:
        state["ef"] = grad_compression.init_error_feedback(leaves)
    return state


class _Loss(nn.Module):
    """A loss function of a model as a module's forward, so that
    ``torch.func.functional_call`` can run it on sampled weights."""

    def __init__(self, loss_fn: Callable, model: nn.Module):
        super().__init__()
        self.loss_fn, self.model = loss_fn, model

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def microbatches(batch: Dict, n: int):
    """The batch's rows split ``n`` ways (``[batch]`` where n <= 1)."""
    if n <= 1:
        return [batch]
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


class TrainStep:
    """One optimizer step (module docstring); ``grads`` alone gives the
    loss, metrics and per-leaf gradients of a batch."""

    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                 accum: int = 1, moe_aux_coef: float = 0.01,
                 lr_schedule: Optional[Callable] = None,
                 compress_grads: bool = False, bayesian_mode: bool = False,
                 num_examples: int = 1_000_000):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.base_loss = make_loss_fn(cfg, build_model(cfg), moe_aux_coef)
        self.accum = accum
        self.lr_schedule = lr_schedule
        self.compress_grads = compress_grads
        self.bayesian_mode = bayesian_mode
        self.num_examples = num_examples

    def loss(self, state: Dict, batch: Dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model = state["model"]
        if not self.bayesian_mode:
            return self.base_loss(model, batch)
        gen = torch.Generator(device=state["step"].device)
        gen.manual_seed(int(state["step"]))
        bparams = {n: {"mu": p, "rho": state["rho"][n]}
                   for n, p in model.named_parameters()}
        on_weights = _Loss(self.base_loss, model)
        return bayesian.elbo_loss(
            gen, bparams,
            lambda w: torch.func.functional_call(
                on_weights, {f"model.{n}": t for n, t in w.items()},
                (batch,)),
            self.num_examples)

    def grads(self, state: Dict, batch: Dict):
        """(loss, metrics, gradients per leaf of ``state_leaves``), the
        mean over ``accum`` microbatches."""
        leaves = state_leaves(state, self.cfg)
        flat = [t for leaf in leaves for t in leaf.tensors]
        n = self.accum
        total, metrics = None, None
        for mb in microbatches(batch, n):
            loss, m = self.loss(state, mb)
            gs = torch.autograd.grad(loss, flat)
            total = list(gs) if total is None else [
                a + b for a, b in zip(total, gs)]
            metrics = dict(m) if metrics is None else {
                k: metrics[k] + m[k] for k in m}
        if n > 1:
            total = [g / n for g in total]
            metrics = {k: v / n for k, v in metrics.items()}
        grads, i = [], 0
        for leaf in leaves:
            grads.append(total[i:i + len(leaf.tensors)])
            i += len(leaf.tensors)
        return metrics["loss"].detach(), {
            k: v.detach() for k, v in metrics.items()}, grads

    def __call__(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        leaves = state_leaves(state, self.cfg)
        loss, metrics, grads = self.grads(state, batch)
        if self.compress_grads:
            grads, new_ef = grad_compression.compress_decompress(
                grads, state["ef"])
        gnorm = adamw.global_norm(grads)
        ok = torch.isfinite(gnorm) & torch.isfinite(loss)
        lr = (self.lr_schedule(state["step"]) if self.lr_schedule is not None
              else self.opt_cfg.lr)
        new_params, new_opt = adamw.update(grads, state["opt"], leaves,
                                           self.opt_cfg, lr)
        with torch.no_grad():
            for leaf, ps in zip(leaves, new_params):
                for t, new in zip(leaf.tensors, ps):
                    t.copy_(torch.where(ok, new, t))
        state["opt"] = adamw.select(ok, new_opt, state["opt"])
        if self.compress_grads:
            state["ef"] = adamw.select(ok, new_ef, state["ef"])
        state["step"] = state["step"] + 1
        state["skipped"] = state["skipped"] + (~ok).to(torch.int32)
        drop_planes(state["model"])
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        metrics.update(grad_norm=gnorm, lr=lr, ok=ok.to(torch.int32))
        return state, metrics


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    **kw) -> TrainStep:
    return TrainStep(cfg, opt_cfg, **kw)


def make_loss_fn(cfg: ArchConfig, model: Optional[Model] = None,
                 moe_aux_coef: float = 0.01) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` of a model's train
    forward (``repro``'s ``make_loss_fn``)."""
    api = model or build_model(cfg)

    def loss_fn(params, batch):
        logits, aux = api.forward_train(params, batch)
        nll = cross_entropy(logits, batch["labels"], cfg.zloss)
        loss = nll + moe_aux_coef * aux["moe_aux"]
        return loss, {"loss": loss, "nll": nll, "moe_aux": aux["moe_aux"]}
    return loss_fn
