"""Median over the program window's cold starts of the time the node
waited for the restore after generation and before the result (the
summed ``invoke.complete_wait`` spans of the call), in ms
(``coldbench/spans.py``)."""
from coldbench.spans import per_cold_start_ms


def read(run):
    return per_cold_start_ms(run, "invoke.complete_wait")
