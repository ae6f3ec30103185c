"""gnuais-tpu on PyTorch and CUDA.

A port of the ``gnuais_tpu`` decode step to PyTorch, with the fused
decode kernels written by hand in CUDA C++ for Hopper (``sm_90a``).  The
JAX package stays the reference: every op here is held bit for bit
against its ``gnuais_tpu`` counterpart on the CPU.

This package imports ``torch`` and nothing of ``jax`` or ``gnuais_tpu``.
It keeps its own copies of the host layers it needs (``constants``,
``config``, ``golden``, ``ais``, ``native``, ``io.audio``, ``io.sinks``,
``runtime.session``, ``runtime.metrics``), which differ from the JAX
package's only in their import lines.

Entry points: ``runtime.pipeline.BatchPipeline`` and ``TorchReceiver``
(the decode step with a carried state), ``runtime.batch.BatchSession``
(the fleet decode), the throughput modes ``parallel.timepar.
time_parallel_decode`` (lanes), ``TimeParSession`` and
``GroupedTimeParSession`` (on a grid of cards, ``parallel.mesh``), the
stream-sharded step ``parallel.sharded.make_sharded_decode``, the
cluster of ``parallel.cluster``, the IQ readers of ``io.iq``, and the
``gnuais-tpu-torch`` command (``gnuais_tpu_torch.cli``), and the
measurement tools (``profile_kernels``, ``roofline``, ``diag_strip``,
``profile_flagship``, ``latency_bench``, ``diag_shard``, each ``python
-m gnuais_tpu_torch.<tool>``).  Every constructor takes an explicit
``device`` or grid; nothing picks one silently.
"""

__version__ = "0.1.0"
