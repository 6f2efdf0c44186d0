"""The benchmark of midd_tpu_torch's serving path (``python3 perfbench/run.py``)."""
