"""The benchmark's plain reference: NumPy and the standard library only.

It rebuilds every eDAG from the workload's definition with its own frozen
scalar tracer (``dag.py`` and one module per tracer, found by the name a
configuration's ``tracer`` key gives), and simulates the machine with its
own event loop (``machine.py``).  It imports nothing of the program under
test, nothing of the JAX package and no JAX.
"""
