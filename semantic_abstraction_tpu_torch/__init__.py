"""semantic_abstraction_tpu_torch: the PyTorch/CUDA port of semantic_abstraction_tpu.

Runs on an NVIDIA H100 (``cuda``) unless the caller asks for the CPU. The
JAX package beside it is the reference each part is tested against; this
package imports neither JAX nor anything of that package.

Every module of the JAX package has its counterpart here: CLIP relevancy
and features (``clip/``, ViT and ModifiedResNet), the 3D nets
(``models/``), the ops with the three hand-written CUDA kernels
(``ops/``, sources in ``ops/csrc/``), the data pipeline (``data/``,
``native/``), training, evaluation and checkpoints (``runtime/``),
data parallelism over ``torch.distributed`` (``parallel/``), THOR datagen
(``datagen/``) and the CLIs (``cli/``).
"""

__version__ = "0.1.0"
