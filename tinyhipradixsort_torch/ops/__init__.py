"""Engines of the PyTorch port (counterpart: ``tinyhipradixsort_tpu/ops``)."""
