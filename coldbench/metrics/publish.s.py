"""Seconds of set-up spent in ``node.publish`` (the catalog's
``FunctionCatalog.publish``: layerwise state, access-order trace, JIF),
summed over the cell's functions, on the benchmark's clock."""


def read(run):
    return sum(run["publish_s"]) if run["publish_s"] else None
