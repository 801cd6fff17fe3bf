"""repro_torch.launch — entry points: serve, train, the mesh, and the dry
run with its census, perf model, roofline, calibration and hill climb."""
