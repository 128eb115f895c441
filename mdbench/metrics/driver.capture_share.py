"""Share of the window's wall time spent warming up and capturing CUDA
graphs (``MDResult.capture_s`` summed over the calls); nothing on an engine
that captures nothing."""


def read(run):
    if not any(c.graph_captures for c in run.calls) or run.window_s <= 0:
        return None
    return 100.0 * sum(c.capture_s for c in run.calls) / run.window_s
