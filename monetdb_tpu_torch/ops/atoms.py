"""Auxiliary atom functions — uuid / url / inet (reference:
monetdb5/modules/atoms/{uuid,url,inet}.c, ~4k LoC of C type machinery).

Design: these types live as canonical strings in the dictionary
substrate (order-preserving codes on device); their functions run once per
distinct value on the host like every other dictionary op. This preserves
the reference's semantics (parsing, component extraction, CIDR containment)
without bespoke device types — the device only ever sees int32 codes.
"""

from __future__ import annotations

import ipaddress
import re
import uuid as _uuid
from urllib.parse import urlparse

from ..column import Cand, Column
from .strfuncs import lut_cand, map_dict, map_dict_int

__all__ = ["new_uuid", "isa_uuid", "url_get", "inet_contains",
           "broadcast_str"]

_UUID_RE = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")


def new_uuid() -> str:
    """uuid.new() (uuid.c UUIDgenerateUuid)."""
    return str(_uuid.uuid4())


def isa_uuid(col: Column) -> Column:
    """isauuid(s) (uuid.c UUIDisaUUID)."""
    from ..dtypes import BOOL
    lut = col.sdict.match_mask(lambda v: _UUID_RE.match(v) is not None)
    c = lut_cand(col, lut)
    m = c.as_mask(col.cap, col.data.device)
    return Column(BOOL, m, col.count, nonil=True)


# -- url components (url.c getProtocol/getHost/getDomain/getFile/...) -------

def _domain(host: str) -> str:
    parts = host.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else host


_URL_GETTERS = {
    "protocol": lambda u: u.scheme,
    "host": lambda u: u.hostname or "",
    "domain": lambda u: _domain(u.hostname or ""),
    "file": lambda u: (u.path.rsplit("/", 1)[-1] if u.path else ""),
    "basename": lambda u: (u.path.rsplit("/", 1)[-1] if u.path else ""),
    "anchor": lambda u: u.fragment,
    "query": lambda u: u.query,
    "user": lambda u: u.username or "",
    "port": lambda u: str(u.port) if u.port else "",
    "context": lambda u: u.path,
}


def url_get(col: Column, what: str) -> Column:
    """getprotocol/gethost/getdomain/getfile/getanchor/getquery/getuser/
    getport/getcontext over URL strings (url.c)."""
    fn = _URL_GETTERS[what]

    def safe(v: str) -> str:
        try:
            return fn(urlparse(v))
        except ValueError:
            return ""
    return map_dict(col, safe)


# -- inet containment (inet.c: << <<= >> >>= operators) ----------------------

def inet_contains(col: Column, network: str, equal_ok: bool = True) -> Cand:
    """addr << network / <<= : is each address contained in the CIDR
    network (inet.c INET_comp_CW)."""
    net = ipaddress.ip_network(network, strict=False)

    def pred(v: str) -> bool:
        try:
            if "/" in v:
                sub = ipaddress.ip_network(v, strict=False)
                if not equal_ok and sub == net:
                    return False
                return sub.subnet_of(net)
            return ipaddress.ip_address(v) in net
        except ValueError:
            return False
    lut = col.sdict.match_mask(pred)
    return lut_cand(col, lut)


def broadcast_str(value: str, cap: int, count: int, device) -> Column:
    """Constant string column on ``device`` (uuid() projection etc.)."""
    import numpy as np
    import torch
    from ..column import StrDict
    from ..dtypes import varchar
    return Column(varchar(),
                  torch.zeros(cap, dtype=torch.int32, device=device), count,
                  sdict=StrDict(np.array([value])))
