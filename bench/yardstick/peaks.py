"""Published peaks of one NVIDIA H100 SXM5 card: the benchmark's frozen
table.

Copied from ``src/repro_torch/launch/roofline.py`` (``PEAK_FLOPS``,
``HBM_BW``) at commit a897cbcf57db933d5cd5b4978c4bd7d258c18c54, with the
float32 rate beside them from the same datasheet.  The figures assume the
card's full 700 W power limit; a run records the limit it found.  Later
PRs of the program do not edit this file: a roofline share is read
against these numbers whatever the program's own table says.
"""

HBM_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM5
BF16_FLOPS = 989e12            # dense, tensor cores
FP32_FLOPS = 67e12             # outside the tensor cores
