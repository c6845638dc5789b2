"""The port's benchmark: one cell per run (``python3 perfbench/run.py``)."""
