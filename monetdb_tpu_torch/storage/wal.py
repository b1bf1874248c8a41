"""Binary write-ahead log — the reference's gdk_logger
(gdk/gdk_logger.c: LOG_CREATE/DESTROY/UPDATE_BULK records :31-40, replay on
startup via log_create :2511, truncation after checkpoint via log_flush
:2642).

Record framing: [magic u32][type u8][txn u64][len u64][payload bytes],
payload = npz archive (named numpy arrays + a JSON header array). A record
is visible to replay only if fully written and followed by (or being) a
COMMIT — torn tails are truncated, like log_readlogs' bounds checking.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["Wal", "REC_CREATE", "REC_DROP", "REC_INSERT", "REC_DELETE",
           "REC_UPDATE", "REC_COMMIT", "REC_CREATE_VIEW", "REC_DROP_VIEW",
           "REC_DDL"]

_MAGIC = 0x4D54575A  # 'MTWZ'
_HDR = struct.Struct("<IBQQ")

REC_CREATE = 1
REC_DROP = 2
REC_INSERT = 3
REC_DELETE = 4
REC_UPDATE = 5
REC_COMMIT = 6
REC_CREATE_VIEW = 7
REC_DROP_VIEW = 8
REC_DDL = 9       # generic catalog DDL (merge/remote/replica defs)


def _pack_payload(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    named = dict(arrays)
    named["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(buf, **named)
    return buf.getvalue()


def _unpack_payload(b: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    with np.load(io.BytesIO(b), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    return meta, arrays


class Wal:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    # -- append (log_tstart/.../log_tend + log_tflush analog) ---------------
    def append(self, rec_type: int, txn: int, meta: dict,
               arrays: Optional[Dict[str, np.ndarray]] = None,
               flush: bool = True) -> None:
        payload = _pack_payload(meta, arrays or {})
        self._f.write(_HDR.pack(_MAGIC, rec_type, txn, len(payload)))
        self._f.write(payload)
        if flush:
            self.flush()

    def commit(self, txn: int) -> None:
        self.append(REC_COMMIT, txn, {}, flush=True)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    # -- replay (log_readlogs analog) ----------------------------------------
    @staticmethod
    def replay(path: str) -> Iterator[Tuple[int, int, dict,
                                            Dict[str, np.ndarray]]]:
        """Yield (type, txn, meta, arrays) for every record of a committed
        transaction, in order. Uncommitted tails are skipped."""
        if not os.path.exists(path):
            return
        records = []
        committed = set()
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HDR.size <= len(data):
            magic, rtype, txn, ln = _HDR.unpack_from(data, off)
            if magic != _MAGIC or off + _HDR.size + ln > len(data):
                break  # torn tail
            payload = data[off + _HDR.size: off + _HDR.size + ln]
            off += _HDR.size + ln
            if rtype == REC_COMMIT:
                committed.add(txn)
            else:
                records.append((rtype, txn, payload))
        for rtype, txn, payload in records:
            if txn in committed:
                meta, arrays = _unpack_payload(payload)
                yield rtype, txn, meta, arrays

    # -- truncation after checkpoint (log_flush analog) ----------------------
    def truncate(self) -> None:
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.close()
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()
