"""vkbench: the end-to-end benchmark of vkresample_tpu_torch on one card.

One command runs one cell of BENCHMARK.json once (see run.py).  Everything
that belongs to one configuration, one traffic mix or one metric sits in a
file of its own, found by its name in BENCHMARK.json:

  configs/<config>.json      the plan as it is run, with its check limits
  traffic/<traffic>.json     the parameters of a traffic mix, which the one
                             generator (loadgen.py) reads
  metrics/<metric>.py        one reader per metric, end to end or per layer
  metrics/cas_kernels/*.txt  the CAS stage's kernel names, one file per set

reference.py is the plain reference of every configuration, and check.py
the comparison that decides `correct`.

Nothing here imports jax or the JAX package; only sut.py imports the port.
"""
