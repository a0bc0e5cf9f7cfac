"""The training framework of the port: the optimizer (``optimizer.py``),
the train step (``train_loop.py``), checkpoints (``checkpoint.py``), the
fault-tolerant loop (``fault.py``) and int8 gradient compression
(``compression.py``)."""
from .fault import FaultTolerantLoop, StragglerStats
from .optimizer import (AdamState, adamw_init, adamw_update, cosine_lr,
                        global_norm)
from .train_loop import make_train_step, shardings_for_train

__all__ = ["AdamState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "make_train_step", "shardings_for_train",
           "FaultTolerantLoop", "StragglerStats"]
