from repro_torch.optim.optimizers import (Optimizer, adagrad, adam,
                                          clip_by_global_norm, get_optimizer,
                                          sgd, tree_leaves, tree_map)

__all__ = ["Optimizer", "adagrad", "adam", "clip_by_global_norm",
           "get_optimizer", "sgd", "tree_leaves", "tree_map"]
