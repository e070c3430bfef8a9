"""semantic_abstraction_tpu_torch: the PyTorch/CUDA port of semantic_abstraction_tpu.

Runs on an NVIDIA H100 (``cuda``) unless the caller asks for the CPU. The
JAX package beside it is the reference each part is tested against; this
package imports neither JAX nor anything of that package.

Ported so far: single-image multi-scale CLIP relevancy (``clip/``), its
``image`` CLI (``cli/generate_relevancy.py``) and the fused attention kernel
(``ops/fused_mha.py``, CUDA source in ``ops/csrc/``).
"""

__version__ = "0.1.0"
