"""Distributed-training utilities of the port (ROADMAP Queue 1, item 8):
for now the fault-tolerance decision layer only."""
