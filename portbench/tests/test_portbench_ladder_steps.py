"""The reader of the decrypt's ladder steps a request on synthetic
contexts: the `steps` of the program's `graphs.ladder` spans at 512 lanes
inside the window's requests, over the requests; nothing where the
program has no such span (a program that runs its ladder as compose2
replays) or no tracer."""

from test_portbench_program_spans import REQS, ctx, read, rec

NAME = "graphs.ladder_steps_per_request.decrypt"


def test_steps_at_512_lanes_inside_the_requests_over_the_requests():
    recs = [rec("graphs.ladder", 100, 400, lanes=512, steps=1094),
            rec("graphs.ladder", 2100, 2400, lanes=512, steps=1090),
            rec("graphs.ladder", 200, 300, lanes=128, steps=1094),      # another batch
            rec("graphs.ladder", 1500, 1600, lanes=512, steps=1094),    # between requests
            rec("graphs.replay", 500, 501, lanes=512)]
    assert read(NAME, ctx(requests=REQS), recs) == (1094 + 1090) / 2


def test_nothing_without_ladder_spans():
    c = ctx(requests=REQS)
    assert read(NAME, c, [rec("graphs.replay", 100, 101, lanes=512)]) is None
    assert read(NAME, c, []) is None
    assert read(NAME, c, None) is None  # a program without the tracer
    assert read(NAME, ctx(requests=[]), [rec("graphs.ladder", 1, 2, lanes=512, steps=9)]) is None
