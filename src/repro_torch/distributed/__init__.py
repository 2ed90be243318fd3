"""Collectives of the worker-parallel steps.  ``inprocess`` runs the W
workers and W shards in one process on one device; ``process_group``
spreads them over ``torch.distributed`` ranks (gloo on the CPU, NCCL on
the cards), each rank holding W / R consecutive workers and their shards.
Both offer the same functions to the steps: ``workers``, ``gather_flat``,
``gather_group``, ``all_gather``, ``reduce_scatter``, ``worker_sum``,
``route`` and ``all_losses``, and a ``size``; along the mesh's ``model`` axis
``model_shards`` and ``model_gather``; and along a leaf's ``data``
dimension ``data_gather`` and ``data_reduce``.  ``sharding`` holds the
reference's rule tables and the placement of a tree on the (data, model)
mesh, ``tensor_parallel`` the split modules' collectives, ``fsdp`` the
weights held over ``data`` and gathered on use.
"""
