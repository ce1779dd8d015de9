"""The benchmark of ``repro_torch``, the PyTorch and CUDA package.

One run serves one cell of ``BENCHMARK.json`` through the port's
``InferenceEngine`` on the card, measures it, and checks what the timed
path produced against the plain float32 reference in
:mod:`perfbench.reference`::

    python3 perfbench/run.py --workload yi-9b.longdoc --seed 7 --seconds 40 --trace 0

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``cells/<workload>.json`` and
``metrics/<metric>.py`` (:mod:`perfbench.manifest`).  Nothing here imports
``jax`` or the JAX package ``repro``, and the reference imports nothing of
``repro_torch``.
"""
