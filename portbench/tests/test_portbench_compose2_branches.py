"""The reader of compose2's fork sites in the decrypt's ladder on synthetic
contexts: the mean `branches` of the program's `graphs.ladder` spans at
512 lanes inside the window's requests; nothing where no such span carries
the attribute (the parent's ladder spans have `lanes` and `steps` alone),
or where there is no tracer or no request."""

from test_portbench_program_spans import REQS, ctx, read, rec

NAME = "graphs.compose2_branches.decrypt"


def test_mean_branches_at_512_lanes_inside_the_requests():
    recs = [rec("graphs.ladder", 100, 400, lanes=512, steps=1094, branches=5),
            rec("graphs.ladder", 2100, 2400, lanes=512, steps=1090, branches=5),
            rec("graphs.ladder", 200, 300, lanes=128, steps=1094, branches=4),   # another batch
            rec("graphs.ladder", 1500, 1600, lanes=512, steps=1094, branches=4),  # between requests
            rec("graphs.replay", 500, 501, lanes=512, branches=3)]
    assert read(NAME, ctx(requests=REQS), recs) == 5


def test_nothing_without_the_attribute():
    c = ctx(requests=REQS)
    assert read(NAME, c, [rec("graphs.ladder", 100, 400, lanes=512, steps=1094)]) is None
    assert read(NAME, c, [rec("graphs.replay", 100, 101, lanes=512, branches=5)]) is None
    assert read(NAME, c, []) is None
    assert read(NAME, c, None) is None  # a program without the tracer
    assert read(NAME, ctx(requests=[]), [rec("graphs.ladder", 1, 2, lanes=512, steps=9,
                                             branches=5)]) is None
