from repro_torch.checkpoint.checkpoint import latest_step, load_tree, restore, save

__all__ = ["save", "restore", "latest_step", "load_tree"]
