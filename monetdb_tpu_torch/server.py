"""Network server & client — the reference's listener + client library
condensed (monetdb5/modules/mal/mal_mapi.c SERVERlisten/SERVERlistenThread:
accept loop, thread per client; clients/mapilib/mapi.c: connect/query/fetch;
common/stream/bs.c length-prefixed block framing).

The port of the reference package's server.py: host code, byte-compatible
on the wire with it (a client of either package talks to a server of the
other).  Queries run on the device of the served ``Database``; each
connection's session thread names that device explicitly and never changes
the thread's current device.

Wire protocol: 4-byte big-endian length-prefixed frames (the MAPI block
stream re-imagined).  Control frames are UTF-8 JSON; the columnar binary
result mode (mvc_export_table_columnar, sql_result.c:1216) follows a JSON
header with one raw little-endian buffer frame per column.

Request:  {"sql": "..."}                        JSON rows response
          {"sql": "...", "mode": "columnar"}    binary columnar response
Response: {"names": [...], "types": [tags], "rows": [[...]]}   (query)
          {"columnar": true, "names": [...], "types": [tags],
           "count": n, "cols": [{"dtype": "<i8"} | {"str": true}]}
            then per column: one raw frame (numeric: n*itemsize bytes;
            string: int32 dict codes frame + \\x00-joined values frame)
          {"affected": n}                                      (DML)
          {"ok": true}                                         (DDL/txn)
          {"error": "message"}                                 (failure)

Authentication (enabled when the Database has registered users): on
connect the server sends {"challenge": salt}; the client answers
{"user": u, "digest": sha512(salt + sha512(password))} — the reference's
challenge-response over hashed passwords (monetdb5/mal/mal_authorize.c
AUTHGeneratePasswordHash, common/utils/mcrypt.c; the stored secret is the
password hash, never the password).
"""

from __future__ import annotations

import datetime
import json
import socket
import socketserver
import struct
import threading
from decimal import Decimal as PyDecimal
from typing import List, Optional, Tuple

from .dtypes import Kind
from .engine import Result
from .session import Session
from .storage import Database
from .storage.columns import tag_type, type_tag

__all__ = ["Server", "Client"]

_LEN = struct.Struct(">I")


def _send(sock: socket.socket, obj) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def _send_raw(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_raw(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    data = bytearray()
    while len(data) < n:
        chunk = sock.recv(min(1 << 20, n - len(data)))
        if not chunk:
            return None
        data.extend(chunk)
    return bytes(data)


def _send_columnar(sock: socket.socket, res: Result) -> None:
    """Columnar binary export (mvc_export_table_columnar,
    sql_result.c:1216): JSON header then one raw little-endian buffer per
    column - no per-value text formatting; a 1M-row numeric column is one
    8 MB memcpy instead of a million JSON numbers."""
    import numpy as np
    cols = []
    frames = []
    for arr, typ, sdict in res.raw:
        arr = np.ascontiguousarray(arr)
        if typ is not None and typ.kind == Kind.STR:
            codes = arr.astype("<i4", copy=False)
            vals = [] if sdict is None else [str(v) for v in sdict.values]
            blob = "\x00".join(vals).encode("utf-8")
            cols.append({"str": True})
            frames.append(np.ascontiguousarray(codes).tobytes())
            frames.append(blob)
        else:
            le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            cols.append({"dtype": le.dtype.str})
            frames.append(np.ascontiguousarray(le).tobytes())
    _send(sock, {"columnar": True, "names": res.names,
                 "types": [type_tag(t) if t is not None else "i64"
                           for t in res.types],
                 "count": len(res.rows) if res.raw is None
                 else (len(res.raw[0][0]) if res.raw else 0),
                 "cols": cols})
    for f in frames:
        _send_raw(sock, f)


def _recv(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    data = b""
    while len(data) < n:
        chunk = sock.recv(min(1 << 16, n - len(data)))
        if not chunk:
            return None
        data += chunk
    return json.loads(data.decode("utf-8"))


def _encode_value(v):
    if isinstance(v, PyDecimal):
        return str(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    return v


def _decode_value(v, tag: str):
    if v is None:
        return None
    if tag.startswith("dec:"):
        return PyDecimal(v)
    if tag == "date":
        return datetime.date.fromisoformat(v)
    return v


class _Handler(socketserver.BaseRequestHandler):
    def _recv_skip_dbframe(self):
        """Read a frame, ignoring a {"database": ...} selector — sent by
        clients that route through the farm proxy (proxy.c consumes it;
        a direct connection simply tolerates it)."""
        msg = _recv(self.request)
        if msg is not None and "database" in msg and "sql" not in msg:
            msg = _recv(self.request)
        return msg

    def handle(self):
        db = self.server.db
        auth_user = None
        if db.users:
            import os
            salt = os.urandom(16).hex()
            _send(self.request, {"challenge": salt})
            reply = self._recv_skip_dbframe()
            if reply is None:
                return
            stored = db.users.get(reply.get("user", ""))
            import hashlib
            want = hashlib.sha512(
                (salt + (stored or "")).encode()).hexdigest()
            # constant-time compare (mcrypt.c does the same)
            import hmac
            if stored is None or not hmac.compare_digest(
                    want, reply.get("digest", "")):
                _send(self.request, {"error": "InvalidCredentialsException:"
                                     " auth failed"})
                return
            _send(self.request, {"ok": True})
            auth_user = reply.get("user")
        # session per connection, under the authenticated identity
        # (privileges enforced per sql_privileges.c table_privs)
        session = Session(db, user=auth_user)
        while True:
            try:
                msg = _recv(self.request)
            except (ConnectionError, OSError):
                return
            if msg is None:
                return
            if "database" in msg and "sql" not in msg:
                continue          # proxy selector on a direct connection
            try:
                res = session.sql(msg["sql"])
                if isinstance(res, Result):
                    if msg.get("mode") == "columnar" and res.raw:
                        _send_columnar(self.request, res)
                        continue
                    _send(self.request, {
                        "names": res.names,
                        "types": [type_tag(t) if t is not None else "i64"
                                  for t in res.types],
                        "rows": [[_encode_value(v) for v in r]
                                 for r in res.rows]})
                elif isinstance(res, int):
                    _send(self.request, {"affected": res})
                else:
                    _send(self.request, {"ok": True})
            except Exception as ex:   # error → client, connection survives
                _send(self.request, {"error": f"{type(ex).__name__}: {ex}"})


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    tls_ctx = None

    def get_request(self):
        sock, addr = super().get_request()
        if self.tls_ctx is not None:
            sock = self.tls_ctx.wrap_socket(sock, server_side=True)
        return sock, addr


class Server:
    """mserver5 analog: owns the Database, accepts clients, one session
    thread per connection.  ``tls=(certfile, keyfile)`` wraps every
    accepted connection in TLS (the reference's OpenSSL stream layer,
    common/stream/; tlstester.py covers the same surface)."""

    def __init__(self, db: Database, host: str = "127.0.0.1", port: int = 0,
                 tls: Optional[Tuple[str, str]] = None):
        self.db = db
        self._srv = _TCP((host, port), _Handler)
        self._srv.db = db
        self._srv.tls_ctx = None
        if tls is not None:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=tls[0], keyfile=tls[1])
            self._srv.tls_ctx = ctx
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address

    def start(self) -> "Server":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        """Accept loop still running (sabaoth liveness,
        common/utils/msabaoth.h:78-87: the daemon watches this state)."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class ColumnarResult:
    """Binary columnar result set (client side of sql_result.c:1216):
    numpy-backed columns, python rows materialized only on demand."""

    def __init__(self, names, types, count, cols):
        self.names = list(names)
        self.types = types
        self.count = count
        self._cols = cols       # ("num", np_arr, None) | ("str", codes, vals)
        self._rows = None

    def __len__(self):
        return self.count

    def numpy(self, name: str):
        """Physical numpy buffer of a column (dict codes for strings)."""
        i = self.names.index(name)
        return self._cols[i][1]

    def column(self, name: str) -> list:
        """Decoded python values of one column."""
        i = self.names.index(name)
        kind, arr, vals = self._cols[i]
        if kind == "str":
            return [None if c < 0 else vals[c] for c in arr.tolist()]
        from .engine import _decode_np
        return _decode_np(arr, self.types[i])

    @property
    def rows(self):
        if self._rows is None:
            decoded = [self.column(n) for n in self.names]
            self._rows = [tuple(d[i] for d in decoded)
                          for i in range(self.count)]
        return self._rows


class Client:
    """mapilib analog: blocking query API over the block stream."""

    def __init__(self, host: str, port: int, user: Optional[str] = None,
                 password: Optional[str] = None,
                 database: Optional[str] = None,
                 tls: bool = False, tls_verify: bool = True,
                 cafile: Optional[str] = None):
        self.sock = socket.create_connection((host, port))
        if tls:
            import ssl
            ctx = ssl.create_default_context(cafile=cafile)
            if not tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
        if database is not None:
            # route through a farm proxy (merovingian proxy.c: the
            # client names its database; the daemon connects it through)
            _send(self.sock, {"database": database})
        if user is not None:
            import hashlib
            ch = _recv(self.sock)
            if ch is None or "challenge" not in ch:
                raise ConnectionError("server did not issue a challenge")
            pwhash = hashlib.sha512((password or "").encode()).hexdigest()
            digest = hashlib.sha512(
                (ch["challenge"] + pwhash).encode()).hexdigest()
            _send(self.sock, {"user": user, "digest": digest})
            resp = _recv(self.sock)
            if resp is None or "error" in resp:
                raise ConnectionError(
                    (resp or {}).get("error", "auth failed"))

    def sql(self, text: str, columnar: bool = False):
        req = {"sql": text}
        if columnar:
            req["mode"] = "columnar"
        _send(self.sock, req)
        resp = _recv(self.sock)
        if resp is None:
            raise ConnectionError("server closed connection")
        if "error" in resp:
            raise RuntimeError(resp["error"])
        if resp.get("columnar"):
            return self._recv_columnar(resp)
        if "rows" in resp:
            types = [tag_type(t) for t in resp["types"]]
            rows = [tuple(_decode_value(v, t) for v, t in
                          zip(r, resp["types"]))
                    for r in resp["rows"]]
            return Result(resp["names"], types, rows)
        if "affected" in resp:
            return resp["affected"]
        return None

    def _recv_columnar(self, hdr: dict) -> "ColumnarResult":
        import numpy as np
        types = [tag_type(t) for t in hdr["types"]]
        cols = []
        for spec in hdr["cols"]:
            if spec.get("str"):
                codes = np.frombuffer(_recv_raw(self.sock), "<i4")
                blob = _recv_raw(self.sock)
                vals = blob.decode("utf-8").split("\x00") if blob else []
                cols.append(("str", codes, vals))
            else:
                buf = _recv_raw(self.sock)
                cols.append(("num", np.frombuffer(buf, spec["dtype"]),
                             None))
        return ColumnarResult(hdr["names"], types, int(hdr["count"]), cols)

    def close(self) -> None:
        self.sock.close()
