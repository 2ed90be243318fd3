"""Collectives of the worker-parallel PS step.  ``inprocess`` runs the W
workers and W shards in one process on one device; a
``torch.distributed`` backend with the same functions waits (ROADMAP.md).
"""
