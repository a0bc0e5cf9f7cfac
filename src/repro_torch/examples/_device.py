"""The examples' ``--device``: the backend every engine call selects."""
from __future__ import annotations

import contextlib
import os


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine and the model run (default: "
                         "the card; without one, cuda raises)")


@contextlib.contextmanager
def on_device(device: str):
    """Run the block with ``$EDAN_TORCH_BACKEND`` set to ``device`` (the
    engine's backend, ``core.backend.select_backend``)."""
    old = os.environ.get("EDAN_TORCH_BACKEND")
    os.environ["EDAN_TORCH_BACKEND"] = device
    try:
        yield
    finally:
        if old is None:
            del os.environ["EDAN_TORCH_BACKEND"]
        else:
            os.environ["EDAN_TORCH_BACKEND"] = old
