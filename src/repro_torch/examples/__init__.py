"""The JAX package's ``examples/`` as modules of the port, run as
``python -m repro_torch.examples.<name>``: ``quickstart``,
``latency_sensitivity``, ``serve_lm`` and ``train_lm``.  Each runs on the
card unless ``--device cpu`` is given, and has a reduced size the tests
use."""
