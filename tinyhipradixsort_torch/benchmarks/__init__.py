"""Benchmarks of the PyTorch port, each runnable with ``python -m``: the
workload matrix (:mod:`.full`, the JAX repo's ``benchmarks/full.py``) and
the weak-scaling harness of the distributed sort (:mod:`.scaling`, its
``benchmarks/scaling.py``). They write JSON only to the path given as
``--out``."""
