"""The wide kernel instances' share of their roofline (rows of 289-320
limbs: K2, K5m, K6a and K6e at k=256), summed over the four: the least
time of their runs in the traced window over their device time there.

Runs and device time come from the device trace: every kernel run whose
name is a wide instance's (the first template argument 10, e.g.
`mag_mul_kernel<10, 4>`). Each is priced as a launch of its kernel's
sites in one compose2 (portbench/roofline_k256.py `wide_sites`: K2's mu,
K5m's t1 and sq, K6a's csum, K6e) at the lanes of the window's
part-decryptions, the `lanes` of the CoFHE nodes' `engine.part_decrypt`
spans (the combine's compose2s run at the same bucket). The runs have to
come in compose2's proportions (two K5m, one K6a and one K6e a K2), else
something other than compose2 ran a wide instance and nothing is read;
so is a window whose part-decryptions ran at more than one lane count,
or a program without wide instances or the span's `lanes`."""

import re

from portbench import roofline_k256, spans

LAYER = "Kernels"
MOVES = "threshold_decrypt_cts_per_s"

WIDE = re.compile(r"(mod_topdown|mag_mul|canon_sm|c3_operands)_kernel(?:<10[,>]|ILi10E)")


def window_lanes(ctx) -> int | None:
    """The one lane count of the CoFHE nodes' part-decryptions in the window."""
    recs = spans.records()
    if not recs:
        return None
    cofhe = spans.request_ids(recs, "cofhe")
    lanes = {r.attrs.get("lanes") for r in recs
             if r.name == "engine.part_decrypt" and r.request_id in cofhe}
    return lanes.pop() if len(lanes) == 1 and None not in lanes else None


def read(ctx):
    if ctx.trace is None:
        return None
    runs, busy = {}, 0.0
    for a, b, name, _ in ctx.trace.dev:
        m = WIDE.search(name)
        if m:
            runs[m.group(1)] = runs.get(m.group(1), 0) + 1
            busy += (b - a) / 1e6
    lanes = window_lanes(ctx)
    if not busy or not lanes:
        return None
    sites = roofline_k256.wide_sites(lanes, ctx.widths)
    n = runs.get("mod_topdown", 0)
    if set(runs) - set(sites) or any(runs.get(k, 0) != n * len(v) for k, v in sites.items()):
        return None
    return 100.0 * n * sum(sum(v) for v in sites.values()) / busy
