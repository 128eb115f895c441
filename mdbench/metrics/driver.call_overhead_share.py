"""Share of the window's calls spent outside their stepping loops:
1 - the ``driver.loop`` spans over the ``md.call`` roots, summed over the
calls. The rest is each call's set-up, first build with its escalations,
first force evaluation and the final state's copies to the host."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    if not calls:
        return None
    loops = spans.named(calls, "driver.loop")
    if not all(loops):
        return None
    whole = sum(c.root.ns for c in calls)
    return 100.0 * (1.0 - sum(s.ns for ls in loops for s in ls) / whole)
