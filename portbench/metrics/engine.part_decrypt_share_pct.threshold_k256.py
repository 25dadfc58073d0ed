"""Share of request wall time inside the CoFHE nodes' part-decryptions at
k=256: the union of the program's `engine.part_decrypt` spans whose
`disc_bits` is the configuration's (2341) and that belong to a CoFHE
node's `node.request`, over the requests. A program whose span has no
`disc_bits` gives nothing to read."""

from portbench import spans
from portbench.trace import share_pct

LAYER = "Engine"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    recs = spans.records()
    if recs is None:
        return None
    cofhe = spans.request_ids(recs, "cofhe")
    return share_pct([(r.start_ns / 1e9, r.end_ns / 1e9) for r in recs
                      if r.name == "engine.part_decrypt" and r.request_id in cofhe
                      and r.attrs.get("disc_bits") == ctx.config["disc_bits"]],
                     ctx.requests)
