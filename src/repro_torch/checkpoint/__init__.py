from repro_torch.checkpoint.store import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
