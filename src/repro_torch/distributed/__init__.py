"""Collectives of the worker-parallel PS step.  ``inprocess`` runs the W
workers and W shards in one process on one device; ``process_group``
spreads them over ``torch.distributed`` ranks (gloo on the CPU, NCCL on
the cards), each rank holding W / R consecutive workers and their shards.
Both offer the same four functions to the step.
"""
