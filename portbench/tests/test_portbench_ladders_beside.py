"""The reader of the share of threshold requests whose CoFHE nodes' ladders
ran beside each other, on synthetic contexts: the `beside` of the program's
`graphs.ladder` spans at 512 lanes that belong to a CoFHE node's request,
inside the window's requests; 0 where the spans have no `beside` (ladders
on one stream), nothing where no request holds such a span."""

import pytest

from test_portbench_program_spans import REQS, ctx, read, rec

NAME = "graphs.ladders_beside_pct.threshold"


def _nodes(a_ms, b_ms, ids=(7, 8)):
    """The two CoFHE nodes' requests and the compute node's, in [a, b] ms."""
    return ([rec("node.request", a_ms, b_ms, request_id=i, role="cofhe") for i in ids]
            + [rec("node.request", a_ms - 1, b_ms + 1, request_id=99, role="compute")])


def _ladder(a_ms, b_ms, request_id, **attrs):
    return rec("graphs.ladder", a_ms, b_ms, request_id=request_id, **{"lanes": 512, **attrs})


def test_reads_0_without_a_beside_attribute():
    recs = (_nodes(10, 900) + _nodes(2010, 2900, ids=(17, 18))
            + [_ladder(100, 800, 7, steps=1090), _ladder(101, 801, 8, steps=1090),
               _ladder(2100, 2800, 17, steps=1090), _ladder(2101, 2801, 18, steps=1090)])
    assert read(NAME, ctx(requests=REQS), recs) == 0.0


def test_reads_100_with_one_beside_a_request():
    recs = (_nodes(10, 900) + _nodes(2010, 2900, ids=(17, 18))
            + [_ladder(100, 800, 7, beside=0, stream=1), _ladder(101, 801, 8, beside=1, stream=2),
               _ladder(2100, 2800, 17, beside=1, stream=1),
               _ladder(2101, 2801, 18, beside=0, stream=2)])
    assert read(NAME, ctx(requests=REQS), recs) == 100.0


def test_a_request_of_ladders_one_after_the_other_counts_against():
    recs = (_nodes(10, 900) + _nodes(2010, 2900, ids=(17, 18))
            + [_ladder(100, 800, 7, beside=0), _ladder(101, 801, 8, beside=2),
               _ladder(2100, 2800, 17, beside=0), _ladder(2101, 2801, 18, beside=0)])
    assert read(NAME, ctx(requests=REQS), recs) == 50.0


def test_ignores_lanes_other_than_512():
    recs = (_nodes(10, 900) + _nodes(2010, 2900, ids=(17, 18))
            + [_ladder(100, 800, 7, beside=0), _ladder(101, 801, 8, beside=0),
               _ladder(200, 300, 8, lanes=128, beside=1),     # another batch
               _ladder(2100, 2800, 17, beside=0), _ladder(2101, 2801, 18, beside=1)])
    assert read(NAME, ctx(requests=REQS), recs) == 50.0
    only_other = _nodes(10, 900) + [_ladder(200, 300, 7, lanes=128, beside=1)]
    assert read(NAME, ctx(requests=REQS), only_other) is None


def test_ignores_spans_outside_the_cofhe_nodes_requests():
    recs = (_nodes(10, 900) + _nodes(2010, 2900, ids=(17, 18))
            + [_ladder(100, 800, 7, beside=0), _ladder(101, 801, 8, beside=0),
               _ladder(120, 700, 99, beside=1),                 # the compute node's
               _ladder(130, 600, 5, beside=1),                  # no node's request
               _ladder(1100, 1800, 7, beside=1),                # between the requests
               _ladder(2100, 2800, 17, beside=1), _ladder(2101, 2801, 18, beside=0)])
    assert read(NAME, ctx(requests=REQS), recs) == 50.0


@pytest.mark.parametrize("recs", [[], None, _nodes(10, 900)])
def test_nothing_to_read(recs):
    assert read(NAME, ctx(requests=REQS), recs) is None
    assert read(NAME, ctx(requests=[]), [_ladder(1, 2, 7, beside=1)]) is None
