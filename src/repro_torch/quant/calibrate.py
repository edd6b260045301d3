"""Absmax calibration and the fixed-point parity harness (port of
``repro/quant/calibrate.py``).

* ``weight_absmax_report`` is the offline calibration pass: per baked
  spectral cache, the absmax and per-block-row scale statistics the codec
  derives from the weights (absmax quantization of static weights needs
  no activation data), and the bytes the planes occupy.
* ``ParityRunner`` / ``parity_report`` / ``servable_parity_sweep`` hold the
  quantized serving stack (a paged pool per ``policy.kv_dtype``, planes per
  ``policy.quant_weights``) against the float32 dense-cache oracle by
  teacher-forced B=1 decode: both sides consume the oracle's greedy token
  every step, and the report gives ``greedy_agreement`` and
  ``max_logit_drift``.  The online shadow oracle (``obs/health.py``) runs
  the same harness.

``repro`` bakes planes with a pure tree transform; here
``precompute_serving_params`` bakes them into the module in place, so
each side of the harness gets its own copy (``fresh_serving_params``).

Left out: nothing.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.circulant import drop_planes
from ..models.registry import build_model, init_params
from ..serve import decode as dec
from ..serve import kvcache as kvc
from ..serve.params import precompute_serving_params
from .codec import (INT4_QMAX, INT8_QMAX, PLANE_NAMES, SCALE_SUFFIX,
                    QuantPolicy, baked_caches)


def weight_absmax_report(params: nn.Module) -> Dict[str, Dict]:
    """``{"<module path>/<cache>": {plane: stats}}`` over every baked (and
    possibly quantized) cache of ``params``: ``wc_cache`` of a ``Linear``,
    ``{up,gate,down}_cache`` of an expert stack.  Per plane:
    ``bytes``, ``absmax``, ``scale_max`` and ``scale_min``; on quantized
    planes the scales are read back rather than derived."""
    report: Dict[str, Dict] = {}
    for path, _, prefix, cache in baked_caches(params):
        entry = {}
        for name in PLANE_NAMES:
            if name not in cache:
                continue
            plane = cache[name]
            stats = {"bytes": plane.numel() * plane.element_size()}
            scale = cache.get(name + SCALE_SUFFIX)
            if scale is not None:
                # uint8 marks packed int4 planes: scale = absmax / 7
                qmax = INT4_QMAX if plane.dtype == torch.uint8 else INT8_QMAX
                s = scale.double()
                stats.update(scale_max=float(s.max()),
                             scale_min=float(s.min()),
                             absmax=float(s.max() * qmax))
            else:
                a = plane.double().abs()
                rows = a.amax(dim=(-2, -1))
                stats.update(absmax=float(a.max()),
                             scale_max=float(rows.max() / INT8_QMAX),
                             scale_min=float(rows.min() / INT8_QMAX))
            entry[name] = stats
        report[f"{path}/{prefix}"] = entry
    return report


# ---------------------------------------------------------------------------
# Teacher-forced parity harness
# ---------------------------------------------------------------------------
def fresh_serving_params(params: nn.Module, cfg: ArchConfig,
                         policy: Optional[QuantPolicy] = None) -> nn.Module:
    """A copy of ``params`` with its planes baked anew (float32, or as
    ``policy`` quantizes them); ``params`` is left as it is."""
    out = copy.deepcopy(params)
    drop_planes(out)
    return precompute_serving_params(out, cfg, policy)


def _prompt_batch(cfg: ArchConfig, toks: np.ndarray, device) -> Dict:
    batch = {"tokens": torch.as_tensor(toks[None].astype(np.int64),
                                       device=device)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.zeros((1, cfg.num_patches, cfg.d_model),
                                       dtype=torch.float32, device=device)
    return batch


class ParityRunner:
    """Reusable teacher-forced parity harness over baked params.

    ``params_o`` carries float32 planes (the oracle, decoding against a
    float32 dense cache), ``params_q`` the planes ``policy`` serves with;
    both on one device.  The prefill-pack steps are kept per page count,
    so the shadow oracle (``obs/health.ShadowOracle``) replays many
    requests through one runner; ``parity_report`` wraps a single run.
    """

    def __init__(self, cfg: ArchConfig, params_o, params_q, *,
                 policy: QuantPolicy, page_size: int = 4):
        self.cfg = cfg
        self.policy = policy
        self.page_size = int(page_size)
        self.params_o = params_o
        self.params_q = params_q
        self.model = build_model(cfg)
        self._prefills: Dict[int, object] = {}

    def _prefill(self, n_pages: int):
        fn = self._prefills.get(n_pages)
        if fn is None:
            fn = dec.make_prefill_pack_step(self.cfg, n_pages,
                                            self.page_size)
            self._prefills[n_pages] = fn
        return fn

    def run(self, prompt, new_tokens: int) -> Dict:
        """Teacher-forced decode of ``new_tokens`` steps on one prompt;
        both paths consume the ORACLE's greedy token each step.  Returns
        ``steps`` / ``greedy_agreement`` / ``max_logit_drift``."""
        with torch.no_grad():
            return self._run(np.asarray(prompt, np.int64),
                             max(int(new_tokens), 1))

    def _run(self, prompt: np.ndarray, new_tokens: int) -> Dict:
        S = len(prompt)
        model, cfg, page_size = self.model, self.cfg, self.page_size
        device = next(self.params_o.parameters()).device

        # oracle: dense float32 cache
        cache = model.init_cache(1, S + new_tokens, dtype=torch.float32,
                                 device=device)
        logits, cache = model.prefill(self.params_o,
                                      _prompt_batch(cfg, prompt, device),
                                      cache)
        tok = int(torch.argmax(logits[0, -1]))

        # quantized: paged pool, pages 1..maxp of a minimal pool
        maxp = kvc.pages_for(S + new_tokens, page_size)
        pool = kvc.build_pool(cfg, maxp + 1, page_size, self.policy,
                              device=device)
        table = torch.arange(1, maxp + 1, dtype=torch.int32,
                             device=device)[None]
        n_pages = kvc.pages_for(S, page_size)
        padded = np.zeros(n_pages * page_size, np.int64)
        padded[:S] = prompt
        first_q, _ok, pool, _ = self._prefill(n_pages)(
            self.params_q, _prompt_batch(cfg, padded, device), pool,
            table[0, :n_pages].long(), S)

        agree = [int(first_q) == tok]
        drift = 0.0
        for j in range(new_tokens - 1):
            pos = S + j
            cur = torch.tensor([[tok]], dtype=torch.int64, device=device)
            lo, cache = model.decode_step(self.params_o, cur, cache, pos)
            lq, pool = model.decode_step(
                self.params_q, cur, pool,
                torch.tensor([pos], dtype=torch.int32, device=device),
                block_table=table)
            lo32 = lo[0, -1].float().cpu().numpy()
            lq32 = lq[0, -1].float().cpu().numpy()
            drift = max(drift, float(np.abs(lq32 - lo32).max()))
            agree.append(int(lq32.argmax()) == int(lo32.argmax()))
            tok = int(lo32.argmax())           # teacher forcing: oracle token
        return {"steps": len(agree),
                "greedy_agreement": float(np.mean(agree)),
                "max_logit_drift": drift}


def parity_report(cfg: ArchConfig, params: nn.Module, *,
                  policy: QuantPolicy, prompt_len: int = 20,
                  new_tokens: int = 16, page_size: int = 4,
                  seed: int = 0) -> Dict:
    """The quantized serving stack against the float32 dense-cache oracle,
    one arch (``repro``'s ``parity_report``): B=1 teacher-forced decode
    of a random prompt from ``seed`` through the real paged machinery
    (prefill-pack and block-table decode steps).  Returns ``arch``,
    ``policy``, ``steps``, ``greedy_agreement`` in [0, 1] and
    ``max_logit_drift`` (max |logits_q - logits_f32| over every compared
    step).  ``params`` is not changed: each side bakes its own copy."""
    rng = np.random.RandomState(seed)
    prompt = rng.randint(1, cfg.vocab_size, size=prompt_len).astype(np.int32)
    runner = ParityRunner(cfg, fresh_serving_params(params, cfg),
                          fresh_serving_params(params, cfg, policy),
                          policy=policy, page_size=page_size)
    out = {"arch": cfg.name, "policy": policy.describe()}
    out.update(runner.run(prompt, new_tokens))
    return out


def servable_parity_sweep(policy: QuantPolicy, *,
                          archs: Optional[Sequence[str]] = None,
                          prompt_len: int = 20, new_tokens: int = 16,
                          page_size: int = 4, seed: int = 0,
                          device=None) -> List[Dict]:
    """``parity_report`` over every continuous-servable registry arch
    (smoke configs, float32 activations so quantization is the only
    delta), on random weights from seed 0 on ``device`` (default: the
    card)."""
    from ..configs.registry import ARCH_IDS, get_smoke_config
    if archs is None:
        archs = [a for a in ARCH_IDS
                 if not kvc.servable_reasons(get_smoke_config(a))]
    out = []
    for arch in archs:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        params = init_params(cfg, seed=0, device=device)
        out.append(parity_report(cfg, params, policy=policy,
                                 prompt_len=prompt_len,
                                 new_tokens=new_tokens,
                                 page_size=page_size, seed=seed))
    return out
