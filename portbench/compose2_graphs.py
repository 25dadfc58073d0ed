"""Device time of one compose2 graph replay in a traced run, from the device
trace alone.

The harness's `compose2@<lanes>` ranges (`harness._traced_window`) mark the
graph launches of the thread that sends the requests; the profiler records
no range on the node network's server threads, where the CoFHE nodes' bank
replays and the compute node's combine run, so a network cell reads its
compose2 time from the kernels themselves. Every kernel of one graph
launch carries the launch's correlation id, and each compose2 runs one K6b
(`compose_prologue_kernel`). A compose2 graph replay is then a launch of
more than one device operation with one K6b and no more operations than
any other such launch: the wNAF ladder's step graphs hold one compose2 (S)
or two (SC) and add the state's copies and the plan's gather to them, so
they are left out, and the time read is compose2's alone, as
`compose2.device_ms.decrypt`'s is.
"""

from __future__ import annotations

PROLOGUE = "compose_prologue_kernel"


def compose2_ms(trace) -> float | None:
    """Mean device ms of the run's compose2 graph replays, or None where no
    graph launch ran one compose2."""
    groups: dict = {}
    for a, b, name, corr in trace.dev:
        if corr:
            ns, n, ops = groups.get(corr, (0, 0, 0))
            groups[corr] = (ns + b - a, n + (PROLOGUE in name), ops + 1)
    ones = [(ns, ops) for ns, n, ops in groups.values() if n == 1 and ops > 1]
    if not ones:
        return None
    fewest = min(ops for _, ops in ones)
    replays = [ns for ns, ops in ones if ops == fewest]
    return sum(replays) / len(replays) / 1e6
