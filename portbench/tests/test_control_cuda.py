"""The control on the card: the references put in the program's place in
the precision below the configuration's must fail the check that the
program passes, at each cell's own size over a short window. On a
machine with a card: ``python -m pytest portbench/tests -m cuda``; it
skips where there is none."""
import math

import pytest

from portbench.bench import run_cell

CELLS = ["room640_slam.laps", "room640_loc.route", "room640_loc.restart"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(card, cell):
    r = run_cell(cell, 2**31 + 4242, 8.0, False, device=card, control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    low = [k for k, v in r["control"].items()
           if k in limits and not (math.isfinite(v) and v <= limits[k])]
    assert low, (r["control"], limits)
    assert r["checks"]["extract_diff"]["value"] <= limits["extract_diff"]
