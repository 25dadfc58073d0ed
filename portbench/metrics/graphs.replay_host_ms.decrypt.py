"""Host ms of one compose2 graph replay at 512 lanes (the decrypt's
ladder): the mean of the program's `graphs.replay` spans at that batch
inside the requests, from the input copies to the output clones enqueued.
Beside `compose2.device_ms.decrypt` it says whether the host or the card
paces the ladder."""

from portbench import spans

LAYER = "Graphs"
MOVES = "decrypt_p90_s"


def read(ctx):
    recs = spans.records()
    if recs is None:
        return None
    return spans.mean_ms([r for r in spans.in_requests(recs, ctx, "graphs.replay")
                          if r.attrs.get("lanes") == 512])
