"""PyTorch + CUDA port of the block-circulant serving stack in ``repro``.

The package mirrors ``repro``'s module names (``repro_torch/core/circulant.py``
is the counterpart of ``repro/core/circulant.py``, and so on) and imports
nothing from it: ``repro`` stays the JAX reference that the tests hold this
package against.  Every Pallas kernel on the serving path is a hand-written
CUDA kernel here (``csrc/``), with a plain PyTorch version beside it in the
same module; a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""
