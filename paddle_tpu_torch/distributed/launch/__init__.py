"""``python -m paddle_tpu_torch.distributed.launch``: the launcher and
its watcher (port of ``paddle_tpu.distributed.launch``)."""
from .main import launch, main  # noqa: F401
from .watcher import (ExitKind, WatchEvent, Watcher, read_heartbeat,  # noqa: F401
                      touch_heartbeat)
