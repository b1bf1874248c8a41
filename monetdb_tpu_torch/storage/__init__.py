"""Persistence layer — the port of the reference package's storage stack:
BBP directory + atomic-rename commit protocol (gdk/gdk_bbp.c:12-66),
write-ahead log (gdk/gdk_logger.c), delta column storage with visibility
(sql/storage/bat/bat_storage.c), checkpointing (store_apply_deltas
sql/storage/store.c:2356) and hot snapshot (store_hot_snapshot
store.c:2903).  Host numpy throughout; a store materializes its tables on
the one device it is opened with (``Database(path, device=...)``)."""

from .database import Database  # noqa: F401
from .wal import Wal  # noqa: F401
