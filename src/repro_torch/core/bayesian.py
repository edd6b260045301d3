"""Variational-inference Bayesian training (port of
``repro/core/bayesian.py``).

Mean-field Gaussian posterior over every weight: q(w) = N(mu,
softplus(rho)^2).  A step samples w = mu + sigma * eps (reparameterization)
and minimizes E_q[NLL] + KL(q || N(0, prior_sigma^2)) / num_examples;
inference uses the posterior mean.  The circulant structure survives an
elementwise perturbation of the generators, so it works on any weights.

Parameters are ``{name: {"mu": tensor, "rho": tensor}}`` (``repro``'s
leaf dicts, keyed by the port's parameter names).  The model's own
parameters are the ``mu`` tensors, so the model is its posterior mean and
serves as it stands (``repro``'s ``posterior_mean`` has nothing to do).
``sample`` draws eps from an explicit ``torch.Generator``: its bits are
not ``jax.random``'s, so it is held to its contract (mean 0, sigma =
softplus(rho)), not to ``repro``'s numbers.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

BParams = Dict[str, Dict[str, torch.Tensor]]


def init_bayesian(params: Dict[str, torch.Tensor], init_rho: float = -5.0
                  ) -> BParams:
    """Wrap deterministic weights into {mu, rho} leaves (``mu`` is the
    weight itself, ``rho`` a new tensor)."""
    return {n: {"mu": p, "rho": torch.full_like(p, init_rho)}
            for n, p in params.items()}


def sigma(rho: torch.Tensor) -> torch.Tensor:
    return F.softplus(rho)


def sample(generator: torch.Generator, bparams: BParams
           ) -> Dict[str, torch.Tensor]:
    """One weight realization: mu + softplus(rho) * eps, eps ~ N(0, 1)."""
    out = {}
    for n, leaf in bparams.items():
        eps = torch.randn(leaf["mu"].shape, generator=generator,
                          device=leaf["mu"].device, dtype=leaf["mu"].dtype)
        out[n] = leaf["mu"] + sigma(leaf["rho"]) * eps
    return out


def kl_to_prior(bparams: BParams, prior_sigma: float = 1.0) -> torch.Tensor:
    """Sum of KL(N(mu, s^2) || N(0, p^2)) over all weights (closed form)."""
    total = None
    for leaf in bparams.values():
        s = sigma(leaf["rho"])
        kl = (math.log(prior_sigma) - torch.log(s)
              + (s ** 2 + leaf["mu"] ** 2) / (2 * prior_sigma ** 2) - 0.5)
        total = kl.sum() if total is None else total + kl.sum()
    return total


def elbo_loss(generator: torch.Generator, bparams: BParams,
              nll_fn: Callable, num_examples: int,
              prior_sigma: float = 1.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ELBO = E_q[NLL] + KL / num_examples on one sampled realization.
    ``nll_fn(w)`` returns ``(nll, metrics)``; returns ``(loss, metrics)``
    with ``kl`` and ``loss`` set in the metrics (``repro``'s Bayesian
    ``loss_fn``)."""
    nll, metrics = nll_fn(sample(generator, bparams))
    kl = kl_to_prior(bparams, prior_sigma)
    loss = nll + kl / num_examples
    return loss, dict(metrics, kl=kl, loss=loss)
