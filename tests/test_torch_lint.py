"""The port's two single homes, held by the reference's own lint visitors.

Words to bytes only in `repro_torch.plan.units`: the reference's RPL100
visitor (`repro.check.lint.raw_byte_arith_rule`), its width names widened to
the port's (``itemsize``, ``in_size``, ``acc_size``), finds no width
multiplication anywhere else in `src/repro_torch`.

A host clock only in `repro_torch.obs.trace`: the reference's RPL104 visitor
(`repro.check.lint.adhoc_timing_rule`), its clock names widened to ``time``,
``time_ns``, ``process_time`` and ``perf_counter``, finds no clock call in
any other port file, nor any import of a clock from ``time`` or attribute
read of one, and ``obs/trace.py`` holds the port's one read. The repository's
rule set cannot name the port's tracer as RPL104's home (its homes are listed
in the reference's ``lint.py``), so this test holds the rule for the port.
"""

import ast
import pathlib

import pytest

from repro.check import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
UNITS = "src/repro_torch/plan/units.py"
PORT_WIDTHS = frozenset({"itemsize", "in_size", "acc_size"})
TRACE = "src/repro_torch/obs/trace.py"
PORT_CLOCKS = frozenset({"time", "time_ns", "process_time", "perf_counter"})


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


# ------------------------------------------------------- one host clock home
@pytest.fixture
def port_clocks(monkeypatch):
    monkeypatch.setattr(lint, "WALL_CLOCK_FNS",
                        lint.WALL_CLOCK_FNS | PORT_CLOCKS)
    return lint.adhoc_timing_rule(allowed=())


def _clock_reads(tree):
    """What a call visitor cannot see: a clock imported from ``time``
    (``from time import perf_counter as pc``) or read as an attribute
    (``f = time.monotonic``), as (line, name)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            out += [(node.lineno, a.name) for a in node.names
                    if a.name in lint.WALL_CLOCK_FNS or a.name == "*"]
        elif isinstance(node, ast.Attribute) \
                and node.attr in lint.WALL_CLOCK_FNS:
            out.append((node.lineno, node.attr))
    return out


def _clock_findings(rule, rel):
    tree = ast.parse((ROOT / rel).read_text())
    return ([(d.line, d.message) for d in rule.visit(tree, rel)],
            _clock_reads(tree))


def test_port_reads_a_clock_only_in_obs_trace(port_clocks):
    files = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    assert TRACE in files and len(files) >= 30
    found = {rel: _clock_findings(port_clocks, rel) for rel in files
             if rel != TRACE}
    assert {rel: f for rel, f in found.items() if f != ([], [])} == {}


def test_obs_trace_is_where_the_clock_read_lives(port_clocks):
    calls, reads = _clock_findings(port_clocks, TRACE)
    assert calls == []
    assert [name for _, name in reads] == ["perf_counter"]


@pytest.mark.parametrize("src,calls,reads", [
    ("t0 = time.time()", 1, 1),
    ("t0 = time.perf_counter_ns()", 1, 1),
    ("dt = process_time() - t0", 1, 0),
    ("from time import perf_counter as pc", 0, 1),
    ("from time import *", 0, 1),
    ("f = time.monotonic", 0, 1),
    ("time.sleep(0.1)", 0, 0),
    ("with Stopwatch() as sw:\n    pass\nms = sw.ms", 0, 0),
])
def test_widened_clock_rule_sees_the_ways_round(port_clocks, src, calls,
                                                reads):
    tree = ast.parse(src)
    assert len(port_clocks.visit(tree, "x.py")) == calls
    assert len(_clock_reads(tree)) == reads
