"""Runnable examples: the JAX package's ``examples/`` on the port.

Each module runs as ``python -m repro_torch.examples.<name>`` (on the
card by default; ``REPRO_TORCH_DEVICE=cpu`` for the CPU) and prints what
the JAX package's example prints, at its sizes.  Its ``run`` function
returns the results as plain values, and ``main`` prints them:

* ``quickstart``      — associative arrays and Fig. 2 on a toy table;
* ``pcap_analytics``  — a captured window through the D4M binding;
* ``pcap_pipeline``   — the six-stage pipeline, then C2 detection;
* ``train_packet_lm`` — a reduced rwkv6 trained on the pipeline's output.
"""
