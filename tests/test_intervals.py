"""IntervalContainer / ActiveTable semantics
(reference: src/util.rs:117-310)."""

import numpy as np

from panacus_jax.utils import ActiveTable, IntervalContainer, intersects, is_contained


def test_interval_union_merging():
    c = IntervalContainer()
    c.add(1, 0, 10)
    c.add(1, 20, 30)
    assert c.get(1) == [(0, 10), (20, 30)]
    # bridge the gap
    c.add(1, 5, 25)
    assert c.get(1) == [(0, 30)]
    # fully enclosed: no change
    c.add(1, 2, 3)
    assert c.get(1) == [(0, 30)]
    # extend right
    c.add(1, 30, 40)
    assert c.get(1) == [(0, 40)]
    # disjoint left
    c.add(2, 50, 60)
    c.add(2, 10, 20)
    assert c.get(2) == [(10, 20), (50, 60)]
    # overlap joining multiple following intervals
    c.add(2, 15, 55)
    assert c.get(2) == [(10, 60)]


def test_interval_total_coverage():
    c = IntervalContainer()
    c.add(7, 0, 10)
    c.add(7, 20, 25)
    assert c.total_coverage(7, None) == 15


def test_active_table_annotation_promotion():
    t = ActiveTable(10, with_annotation=True)
    t.activate_n_annotate(3, 10, 0, 4)
    assert not t.is_active(3)
    assert t.get_active_intervals(3, 10) == [(0, 4)]
    # completing the node promotes it to fully active
    t.activate_n_annotate(3, 10, 4, 10)
    assert t.is_active(3)
    assert t.get_active_intervals(3, 10) == [(0, 10)]


def test_intersects_and_contained():
    v = [(0, 5), (10, 20), (30, 40)]
    assert intersects(v, (4, 6))
    assert intersects(v, (20, 25))  # touching right bound counts
    assert not intersects(v, (21, 29))
    assert is_contained(v, (12, 18))
    assert not is_contained(v, (18, 22))
    assert not is_contained([], (0, 1))


def test_threshold_parsing_rejects_rust_invalid_forms():
    # Rust usize/f64 from_str reject '-', '_' separators (hist.rs:207-258)
    import pytest

    from panacus_jax.utils import parse_threshold_list

    assert [t.value for t in parse_threshold_list("0,1,2", "absolute")] == [
        0.0,
        1.0,
        2.0,
    ]
    assert parse_threshold_list("+5", "absolute")[0].value == 5.0
    for bad in ["-5", "1_0", "1.0", "0x5", ""]:
        with pytest.raises(ValueError):
            parse_threshold_list(bad, "absolute")
    with pytest.raises(ValueError):
        parse_threshold_list("0._5", "relative")
    # 'either': int first, then float in [0,1]
    ts = parse_threshold_list("2,0.5", "either")
    assert (ts[0].relative, ts[1].relative) == (False, True)
