"""Synthetic training data of the port (a copy of ``repro.data``)."""
