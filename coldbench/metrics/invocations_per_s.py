"""Invocations completed (of the cell's kind, without error) over the
window's seconds, from its start until the last request submitted in it
has its result; the clients' evictions take their share of the time."""


def read(run):
    return len(run["ok"]) / run["window_s"] if run["ok"] else None
