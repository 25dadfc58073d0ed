"""Host ms of one compose2 graph replay at 512 lanes on the CoFHE nodes
(their part-decryptions' ladders): the mean of the program's
`graphs.replay` spans at that batch that belong to a CoFHE node's
`node.request`, inside the requests. Both nodes' threads share one process
and its interpreter lock: contention shows as a rise over
`graphs.replay_host_ms.decrypt`."""

from portbench import spans

LAYER = "Graphs"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    recs = spans.records()
    if recs is None:
        return None
    cofhe = spans.request_ids(recs, "cofhe")
    return spans.mean_ms([r for r in spans.in_requests(recs, ctx, "graphs.replay")
                          if r.attrs.get("lanes") == 512 and r.request_id in cofhe])
