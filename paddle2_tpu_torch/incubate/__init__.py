"""Incubating APIs of the port (counterpart of ``paddle2_tpu.incubate``)."""
