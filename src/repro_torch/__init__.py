"""PyTorch port of the EDAN analysis engine and its model zoo, for NVIDIA
Hopper.

* The engine's main path — trace → eDAG → batched (max,+) level recurrence
  → §4 replay simulator → Eq 1–4 reports — with the level recurrence in a
  hand-written CUDA kernel (``kernels/level_step.py``,
  ``csrc/level_step.cu``).
* Suites, placement, the schedule cache and trace store, the analysis
  service (``serve/analysis.py``) and the two frontends (``core/hlo.py``,
  ``core/fxgraph.py``, ``models/tracing.py``), on the same kernel.
* The model zoo's serving path — ``launch/serve.py`` → ``serve.ServeEngine``
  → ``models.ModelApi`` → the six families — with the WKV6 and SSD
  recurrences and flash attention in hand-written CUDA kernels
  (``kernels/wkv6.py``, ``kernels/ssd.py``, ``kernels/flash_attention.py``;
  ``csrc/``).
* The training framework — ``launch/train.py`` → ``train.FaultTolerantLoop``
  → ``train.make_train_step`` (AdamW, gradient accumulation) on the data
  pipeline (``data/``), with checkpoints, int8 gradient compression and
  the sharding rules (``sharding/``).  The train step differentiates the
  reference's plain math (``kernels.ops.differentiable``).

Entry points run on the card unless the caller selects the ``cpu`` backend
(``backend="cpu"``, ``device="cpu"`` or ``$EDAN_TORCH_BACKEND=cpu``).
"""
