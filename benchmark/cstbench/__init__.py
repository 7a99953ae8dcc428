"""The benchmark harness of ``cst_captioning_tpu_torch`` (see
``benchmark/run.py``)."""
