"""The sqllogictest corpus through the PyTorch port's ``Session``
(``SqlLogicRunner(Session(Database(device="cpu")))``).

* every file of tests/sqllogic/*.test;
* a fixed sample of the pinned reference corpus (tests/sqllogic/ref/, held
  to tests/sqllogic/REF_LEDGER.md, which records the JAX package's result):
  every 8th ``pass`` file by name and every known-fail.  A ``pass`` file
  must pass and run at least one record; a known-fail must still fail.
  Files that upstream runs in sequence use the ledger generator's
  ``CHAINS``, as the ledger did.

Each file is one case.  This file imports no JAX.
"""

import glob
import os
import re

import pytest

from monetdb_tpu_torch.session import Session
from monetdb_tpu_torch.storage import Database
from monetdb_tpu_torch.testing import SqlLogicRunner

from gen_ref_ledger import CHAINS

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "sqllogic", "ref")
LOCAL = sorted(glob.glob(os.path.join(HERE, "sqllogic", "*.test")))


def _ledger():
    out = {}
    with open(os.path.join(HERE, "sqllogic", "REF_LEDGER.md")) as f:
        for line in f:
            m = re.match(r"\|\s*(\S+\.test)\s*\|\s*(pass|FAIL)\s*\|", line)
            if m:
                out[m.group(1)] = m.group(2)
    return out


_LED = _ledger()
_PASS = sorted(n for n, st in _LED.items() if st == "pass")
SAMPLE = sorted(_PASS[::8] + [n for n, st in _LED.items() if st == "FAIL"])


def run_ref_file(name: str):
    """(status, records run, reason) of one corpus file on a fresh store,
    as tests/gen_ref_ledger.py's ``run_one`` records it."""
    db = Database(device="cpu")
    prereqs, user = CHAINS.get(name, ([], None))
    for pre in prereqs:
        SqlLogicRunner(Session(db)).run_file(os.path.join(REF, pre))
    runner = SqlLogicRunner(Session(db, user=user))
    try:
        return "pass", runner.run_file(os.path.join(REF, name)), ""
    except Exception as ex:     # the ledger records any failure as FAIL
        return "FAIL", runner.n_run, f"{type(ex).__name__}: {ex}"


@pytest.mark.parametrize("path", LOCAL,
                         ids=[os.path.basename(p) for p in LOCAL])
def test_local_file(path):
    n = SqlLogicRunner(Session(Database(device="cpu"))).run_file(path)
    assert n > 0


def test_sample_covers_the_ledger():
    assert len(_LED) >= 900 and len(SAMPLE) >= 110
    assert sum(_LED[n] == "FAIL" for n in SAMPLE) == \
        sum(st == "FAIL" for st in _LED.values()) == 4


@pytest.mark.parametrize("name", SAMPLE)
def test_ref_file_holds_its_ledger_status(name):
    status, n, why = run_ref_file(name)
    if _LED[name] == "pass":
        assert status == "pass", why[:400]
        with open(os.path.join(REF, name)) as f:
            has_records = any(ln.startswith(("statement", "query"))
                              for ln in f)
        assert n > 0 or not has_records, "ran no records"
    else:
        assert status == "FAIL", "known-fail now passes: update the ledger"
