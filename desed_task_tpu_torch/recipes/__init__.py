"""Recipe entry points of the port (python -m desed_task_tpu_torch.recipes.<name>)."""
