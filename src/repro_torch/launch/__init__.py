"""repro_torch.launch — drivers (serving so far)."""
