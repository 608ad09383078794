"""``chip_smoke.py``'s launch table against the port's launch counters.

The card harness checks every path's launches against ``PATH_LAUNCHES``.
Every kernel the table names must have a counter
(``obs.profiling.COUNTERS``), and every counted kernel must be launched by
some path of the table, so that each kernel runs in some whole path on the
card.  ``chip_smoke`` imports only the standard library at its top level,
so it imports here without a card.
"""

import sys
from pathlib import Path

from splatpu_torch.obs.profiling import COUNTERS

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_launch_table_covers_every_counted_kernel():
    tables = [t for path in chip_smoke.PATH_LAUNCHES.values() for t in path.values()]
    launched = {k for table in tables for k, n in table.items() if n}
    named = {k for table in tables for k in table}
    assert named <= set(COUNTERS)
    assert set(COUNTERS) <= launched
