"""PyTorch port of the EDAN analysis engine and its model zoo, for NVIDIA
Hopper.

* The engine's main path — trace → eDAG → batched (max,+) level recurrence
  → §4 replay simulator → Eq 1–4 reports — with the level recurrence in a
  hand-written CUDA kernel (``kernels/level_step.py``,
  ``csrc/level_step.cu``).
* The model zoo's serving path — ``launch/serve.py`` → ``serve.ServeEngine``
  → ``models.ModelApi`` → rwkv6 (``ssm``) and zamba2 (``hybrid``) — with
  the WKV6 and SSD recurrences in hand-written CUDA kernels
  (``kernels/wkv6.py``, ``kernels/ssd.py``; ``csrc/wkv6.cu``,
  ``csrc/ssd.cu``).

Entry points run on the card unless the caller selects the ``cpu`` backend
(``backend="cpu"``, ``device="cpu"`` or ``$EDAN_TORCH_BACKEND=cpu``).
"""
