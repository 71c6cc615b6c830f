"""PyTorch + CUDA port of seaweedfs_tpu's erasure-coding path.

The package mirrors the JAX package's module paths (``ec/codec.py``,
``ec/encoder.py``, ``storage/needle.py``, ...) and public names, with the
GF(2^8) matrix product run by a hand-written CUDA kernel for Hopper
(``csrc/gf_matmul.cu``). It imports torch and numpy and nothing of the JAX
package. Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
