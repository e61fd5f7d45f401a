"""Words to bytes only in `repro_torch.plan.units`: the reference's own RPL100
visitor (`repro.check.lint.raw_byte_arith_rule`), its width names widened
to the port's (``itemsize``, ``in_size``, ``acc_size``), finds no width
multiplication anywhere else in `src/repro_torch`."""

import ast
import pathlib

import pytest

from repro.check import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
UNITS = "src/repro_torch/plan/units.py"
PORT_WIDTHS = frozenset({"itemsize", "in_size", "acc_size"})


@pytest.fixture
def port_widths(monkeypatch):
    monkeypatch.setattr(lint, "WIDTH_NAMES", lint.WIDTH_NAMES | PORT_WIDTHS)
    return lint.raw_byte_arith_rule(allowed=())


def _findings(rule, rel):
    return lint.lint_file(ROOT / rel, rel, [rule])


def test_port_converts_words_to_bytes_only_in_units(port_widths):
    files = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    assert UNITS in files and len(files) >= 30
    found = [d for rel in files if rel != UNITS
             for d in _findings(port_widths, rel)]
    assert found == [], [(d.file, d.line, d.message) for d in found]


def test_units_is_where_the_conversion_lives(port_widths):
    found = _findings(port_widths, UNITS)
    assert [d.code for d in found] == ["RPL100"]


@pytest.mark.parametrize("src,hits", [
    ("b = n * t.dtype.itemsize", 1),
    ("b = 2 * in_size * (bm + bn)", 1),
    ("b = bm * bn * acc_size", 1),
    ("b = nbytes(n, t.dtype.itemsize)", 0),
])
def test_widened_rule_sees_the_port_names(port_widths, src, hits):
    assert len(port_widths.visit(ast.parse(src), "x.py")) == hits
