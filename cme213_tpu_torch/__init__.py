"""cme213_tpu_torch — the PyTorch/CUDA port of ``cme213_tpu``.

Same subpackage layout as the JAX package (``core``, ``config``, ``grid``,
``verify``, ``ops``, ``apps``), written the PyTorch way: plain functions on
tensors with an explicit ``device``.  The stencil kernels are CUDA C++ for
Hopper (``csrc/``), built at first use on a CUDA tensor.  Importing the
package has no side effects.
"""

__version__ = "0.1.0"
