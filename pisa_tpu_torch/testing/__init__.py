"""Test-support harnesses shipped with the port (counterpart of
``pisa_tpu/testing``)."""
