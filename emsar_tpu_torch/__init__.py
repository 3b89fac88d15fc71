"""emsar_tpu_torch — EMSAR quantification and SE index build in PyTorch, for
NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``emsar_tpu``, held module by module
against it (the JAX package is the frozen reference; ``tests/test_torch_*``
feed both the same inputs).  Module names mirror ``emsar_tpu`` so each
counterpart is easy to find:

* ``device``              — device resolution (``EMSAR_TORCH_DEVICE``)
* ``index.build``         — the SE ``.rsh`` build dispatcher and the host
  NumPy builder (``EMSAR_TORCH_BUILD_BACKEND``)
* ``index.device_build``  — the SE build on the torch device
* ``model.solver``        — CSR SQUAREM EM over the global edge list
* ``model.dense``         — dense batched SQUAREM over padded module classes
* ``kernels.squarem``     — the hand-written CUDA SQUAREM block
  (``csrc/squarem_block.cu``), the port of the Pallas ``_pallas_block``
* ``kernels.segment_sum`` — the CSR solver's deterministic segment sums
  (``csrc/segment_sum.cu``)
* ``kernels.window_hash`` — the SE build's hash pass
  (``csrc/window_hash.cu``)
* ``model.quantify``      — per-sample orchestration
* ``cli.emsar``           — the ``emsar`` quantifier (``-I``; ``-x`` for SE)
* ``cli.emsar_build``     — the ``emsar-build`` SE index builder

The JAX-free host stages (``.rsh`` I/O, C++ ingest, module decomposition,
the f64 polish, writers) are imported from ``emsar_tpu`` unchanged.  This
package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
