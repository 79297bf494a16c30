"""Serving stack of the port: instance, node, cluster, engine facade."""
