"""The harness of the benchmark of ``edrgp_tpu_torch`` (see ``run.py``)."""
