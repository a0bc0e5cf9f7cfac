"""Traffic drivers, one module per ``driver`` name a traffic file gives.
Each exposes ``Driver(ctx)`` with ``setup``, ``window(seconds)``,
``work_per_step``, ``release``, ``check(control=False)`` and ``close``."""
