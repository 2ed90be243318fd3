"""Collectives of the worker-parallel steps.  ``inprocess`` runs the W
workers and W shards in one process on one device; ``process_group``
spreads them over ``torch.distributed`` ranks (gloo on the CPU, NCCL on
the cards), each rank holding W / R consecutive workers and their shards.
Both offer the same functions to the steps: ``workers``, ``gather_flat``,
``all_gather``, ``reduce_scatter``, ``worker_sum``, ``route`` and
``all_losses``, and a ``size``.
"""
