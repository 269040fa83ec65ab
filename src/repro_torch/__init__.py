"""PyTorch/CUDA port of the Persia reproduction, laid out module for module
like the JAX package ``repro`` beside it.

This package holds the CTR serving path and hybrid training.
``ServingService`` micro-batches requests, ``PersiaTrainer.serve_lookup``
reads every table's pooled bags through ``backend.read_pooled_all``
(uniform-shuffle row placement or a host_lru table's cache slots and
host-store misses, the worker-side dedup plan, then one launch of the bag
CUDA kernel, as ``unique_bag`` or ``embedding_bag``), and the FFNN
plus a sigmoid turns them into predictions. ``PersiaTrainer.step`` trains
in sync, hybrid(tau) and async modes: the pooled lookup through the bag
kernel, the FFNN's backward and a hand-written Adam, and each table's put
through the ``fused_backward`` CUDA kernel and its bounded-staleness queue;
``save``/``restore`` use the JAX package's checkpoint format.

Ground rules:

* The JAX package is the reference and stays as it is. Each module here
  keeps its counterpart's name (``repro_torch.core.backend`` <->
  ``repro.core.backend``) so the two read side by side.
* Nothing here imports ``jax`` or anything of ``repro``, not even its
  JAX-free modules (``data/ctr.py``, ``configs/*``, ``serving/traffic.py``):
  the port keeps its own copies of those. Only the parity tests import
  both packages.
* Entry points run on the card by default. They take an explicit
  ``device`` that defaults to ``"cuda"`` and raise when no GPU is visible
  unless the caller asked for ``"cpu"`` (as the CPU tests do).
* Nothing falls back quietly. A kernel wrapper runs its plain torch version
  only for tensors that lie on the CPU; for CUDA tensors it launches the
  kernel or raises.
"""
