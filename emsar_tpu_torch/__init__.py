"""emsar_tpu_torch — EMSAR quantification and SE index build in PyTorch, for
NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``emsar_tpu``, held module by module
against it (the JAX package is the frozen reference; ``tests/test_torch_*``
feed both the same inputs).  Module names mirror ``emsar_tpu`` so each
counterpart is easy to find:

* ``device``              — device resolution (``EMSAR_TORCH_DEVICE``)
* ``index.build``         — the SE and PE ``.rsh`` build dispatchers and
  the host NumPy builders (``backend="numpy"``)
* ``index.device_build``  — the SE build on the torch device
* ``index.device_build_pe`` — the PE build on the torch device
* ``model.solver``        — CSR SQUAREM EM over the global edge list
* ``model.dense``         — dense batched SQUAREM over padded module classes
* ``kernels.squarem``     — the hand-written CUDA SQUAREM block
  (``csrc/squarem_block.cu``), the port of the Pallas ``_pallas_block``
* ``kernels.segment_sum`` — the CSR solver's deterministic segment sums
  (``csrc/segment_sum.cu``)
* ``kernels.window_hash`` — the builds' hash pass
  (``csrc/window_hash.cu``)
* ``kernels.pe_candidates`` — the PE build's mate2 candidate expansion
  with the singleton clusters resolved (``csrc/pe_candidates.cu``)
* ``kernels.measure``     — device and host times and roofline bounds of
  the kernels (``chip_smoke.py``, ``bench``)
* ``bench.segment_sum_ab`` — the CSR segment sums against another
  checkout's, on the card
* ``bench.kernel_ab``     — ``window_hash``, ``squarem_block`` and
  ``pe_candidates`` against another checkout's, on the card
* ``model.quantify``      — per-sample orchestration
* ``cli.emsar``           — the ``emsar`` quantifier (``-I``; ``-x`` for SE)
* ``cli.emsar_build``     — the ``emsar-build`` SE index builder

The host stages are copies of the JAX package's modules at the same
relative paths, changed only in their imports: ``config``, ``sim``,
``utils.timing``, ``io`` (FASTA, ``.rsh``, bowtie, SAM, BAM, writers),
``ingest`` (the collapser and the C++ ingest and f64 polish of
``csrc/ingest.cc`` and ``csrc/solver.cc``, built with g++ at first use into
``_build/``), ``model.modules``, ``index.pack`` and ``cli.common``.  This
package imports ``torch``, never ``jax`` and nothing of ``emsar_tpu``.
"""

__version__ = "0.1.0"
