"""Share of the time in which no operation ran on the card, in the window of
the inference cells: 1 - the device's busy seconds an item in the
trace (the union of its operations' intervals) times the items a second of the
untraced window. The traced window itself is not the base: the profiler's
buffer handling stalls the host in it."""


def read(run):
    per_item = run.trace.busy_s / run.trace.items
    return 100.0 * (1.0 - per_item * run.rate / run.traffic["batch"])
