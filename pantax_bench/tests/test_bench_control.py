"""The control (the reference of every fourth read in the program's
place) fails the comparison at a size a test run holds, and the
reference against itself passes it."""
from __future__ import annotations

from pantax_bench import check, control, gen, run


def test_control_fails_every_number(tiny_root, tmp_path):
    spec = run.load_cell(tiny_root, "tinyscale.short")
    limits = spec["workload"]["limits"]
    com = gen.community(spec["config"])
    rows = control.control_numbers(spec["traffic"], spec["workload"], com,
                                   seed=2**31 + 99, tmp=tmp_path)
    for r in rows:
        assert all(r["control"][n] > limits[n] for n in check.NUMBERS), r
        assert all(r["self"][n] <= limits[n] for n in check.NUMBERS), r
