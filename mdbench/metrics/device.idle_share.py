"""Share of the profiled stretch (host clock, from the profiler's start to
its stop) in which no kernel, copy or fill ran on the card; on several
cards, of the stretches' mean over the cards."""


def read(run):
    window = run.extra.get("trace_window_s", 0.0)
    if not run.profile or window <= 0:
        return None
    return 100.0 * (1.0 - run.extra["busy_s"] / window)
