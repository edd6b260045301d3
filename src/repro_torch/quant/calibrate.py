"""Absmax calibration report (port of the first half of
``repro/quant/calibrate.py``).

``weight_absmax_report`` is the offline calibration pass: per baked
spectral cache, the absmax and per-block-row scale statistics the codec
derives from the weights (absmax quantization of static weights needs no
activation data), and the bytes the planes occupy.

Not ported yet: the teacher-forced parity harness (``ParityRunner``,
``parity_report``, ``servable_parity_sweep``), which decodes against a
dense cache, i.e. the batch engine.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .codec import (INT4_QMAX, INT8_QMAX, PLANE_NAMES, SCALE_SUFFIX,
                    baked_caches)


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
