"""Operational tooling: license verification, usage flushing, license service
(the port's own copies of ``oscillink_tpu/tools``)."""
