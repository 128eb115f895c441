"""Share of the profiled stretch in which the card was idle and the host
was in none of the port's spans: the stretch (host clock, as
``device.idle_share`` takes it), less the union of its device rows and of
the window's calls' spans other than the roots, on the profiler's
timebase, over the stretch. Logs the idle milliseconds under each span
name."""

from mdbench import spans

measure = spans.take

NS = 1_000_000_000


def read(run):
    p, st = run.profile, run.stretch
    if not p or st is None or st.t0 is None or st.t1 is None:
        return None
    calls = spans.window_calls(run)
    start = spans.trace_start_ns(st.prof)
    if not calls or start is None:
        return None
    clock = calls[0].root.attrs["clock"]
    lo, hi = (spans.to_trace_us(round(t * NS), clock, start)
              for t in (st.t0, st.t1))
    if hi <= lo:
        return None
    inside = spans.span_intervals(calls, start)
    idle = spans.gaps(spans.union([(a, b) for a, b, _ in p["spans"]],
                                  lo, hi), lo, hi)
    under = spans.idle_by_span(idle, inside, lo, hi)
    print("idle under the port's spans (ms, of a "
          f"{(hi - lo) * 1e-3:.3f} ms stretch): " + ", ".join(
              f"{name} {us * 1e-3:.3f}" for name, us in
              sorted(under.items(), key=lambda kv: -kv[1])), flush=True)
    unspanned = spans.length(idle) - spans.overlap(
        idle, spans.union([(a, b) for a, b, _ in inside], lo, hi))
    return 100.0 * unspanned / (hi - lo)
