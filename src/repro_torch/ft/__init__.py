"""Fault tolerance of the port: JIF checkpoints, health, checkpoint publishing."""
