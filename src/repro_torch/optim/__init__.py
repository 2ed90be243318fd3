from repro_torch.optim.optimizers import (Optimizer, adagrad, adam,
                                          get_optimizer, sgd, tree_leaves,
                                          tree_map)

__all__ = ["Optimizer", "adagrad", "adam", "get_optimizer", "sgd",
           "tree_leaves", "tree_map"]
