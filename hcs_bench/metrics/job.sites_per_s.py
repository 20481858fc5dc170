"""Sites a second of the whole job: the sites whose four CSVs were written
in the stretch after the profiler stopped, over its length (the window
closes when the job in flight has written its CSVs). The same quantity as
the window's rate, read in a traced run; it stands per layer because the
host's speed spreads it from run to run by more than an end-to-end bound
may hold."""


def read(run):
    if run.span_s <= 0 or not run.sites:
        return None
    return run.sites / run.span_s
