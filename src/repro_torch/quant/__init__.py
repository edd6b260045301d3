"""repro_torch.quant: fixed-point inference quantization for the serving
stack (port of ``repro/quant``): the absmax int8/int4 codec over the baked
spectral planes and the paged KV pool (``codec``), and the offline
calibration report and the teacher-forced parity harness
(``calibrate``).  ``QuantPolicy`` is the one config
object the engine threads through ``serve/kvcache.build_pool``,
``serve/params`` and the kernels."""
from .codec import (QuantPolicy, absmax_scale, dequantize, pack_int4,
                    page_scatter, plane_clip_report, plane_from_cache,
                    quantize, quantize_page_block, quantize_plane,
                    quantize_plane_cache, quantize_serving_params,
                    saturation_counts, unpack_int4)

__all__ = [
    "QuantPolicy", "absmax_scale", "dequantize", "pack_int4",
    "page_scatter", "plane_clip_report", "plane_from_cache", "quantize",
    "quantize_page_block", "quantize_plane", "quantize_plane_cache",
    "quantize_serving_params", "saturation_counts", "unpack_int4",
]
