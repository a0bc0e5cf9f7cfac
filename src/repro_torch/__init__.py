"""PyTorch port of the EDAN analysis engine, for NVIDIA Hopper.

The engine's main path — trace → eDAG → batched (max,+) level recurrence →
§4 replay simulator → Eq 1–4 reports — with the level recurrence in a
hand-written CUDA kernel (``kernels/level_step.py``, ``csrc/level_step.cu``).
Entry points run on the card unless the caller selects the ``cpu`` backend
(``backend="cpu"`` or ``$EDAN_TORCH_BACKEND=cpu``).
"""
